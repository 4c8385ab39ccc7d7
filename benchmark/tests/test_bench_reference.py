"""The plain reference against the program at a tiny size on the CPU:
renders, the NCC, pose gradients and density gradients."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import geometry, ncc, phantom, render

SHAPE, SPACING = (20, 18, 10), (4.0, 4.0, 10.0)
ROT = torch.tensor([[0.01, math.pi / 2 + 0.02, -0.01], [0.03, math.pi / 2 - 0.01, 0.02]])
TRANS = torch.tensor([[0.0, 850.0, 0.0], [5.0, 840.0, -3.0]])
KW = dict(parameterization="euler_angles", convention="ZXY")


@pytest.fixture(scope="module")
def scene():
    from diffdrr_tpu_torch.data import Image, read

    hu = phantom.chest_hu(SHAPE, torch.randn((8, 8, 4), generator=torch.Generator().manual_seed(3)))
    subject = read(Image(hu.numpy(), np.diag([*SPACING, 1.0])), orientation="AP")
    subject.to("cpu")
    geo = geometry.Geometry(sdd=1020.0, height=12, width=12, delx=14.0, dely=14.0,
                            shape=SHAPE, spacing=SPACING)
    return subject, geo, phantom.hu_to_density(hu)


def _drr(subject, renderer, **kw):
    from diffdrr_tpu_torch import DRR

    return DRR(subject, sdd=1020.0, height=12, delx=14.0, renderer=renderer, device="cpu", **kw)


def _ref(geo, density, renderer, rot, trans, n_points=None):
    src, tgt, w = geo.rays(rot, trans)
    B, N, _ = tgt.shape
    args = (density, src.expand(B, N, 3).reshape(-1, 3), tgt.reshape(-1, 3), w.reshape(-1))
    if renderer == "siddon":
        return render.siddon(*args).reshape(B, 1, 12, 12)
    axis = geo.march_axis(rot.detach(), trans.detach())[0]
    h, n_steps = render.march_steps(SHAPE[axis], n_points)
    return render.joseph(*args, axis=axis, h=h, n_steps=n_steps).reshape(B, 1, 12, 12)


@pytest.mark.parametrize("renderer,n_points", [("siddon", None), ("trilinear", 500),
                                               ("trilinear", 7)])
def test_render_and_pose_gradient(scene, renderer, n_points):
    subject, geo, density = scene
    kw = {} if n_points is None else {"n_points": n_points}
    rot = ROT.clone().requires_grad_(True)
    img = _drr(subject, renderer, **kw)(rot, TRANS, **KW)
    rot64 = ROT.double().requires_grad_(True)
    want = _ref(geo, density, renderer, rot64, TRANS.double(), n_points)
    assert float((img.detach().double() - want.detach()).abs().max() / want.abs().max()) < 1e-5
    weight = torch.linspace(0.5, 1.5, img.numel()).reshape(img.shape)
    (g,) = torch.autograd.grad((img * weight).sum(), rot)
    (g64,) = torch.autograd.grad((want * weight.double()).sum(), rot64)
    assert float((g.double() - g64).abs().max() / g64.abs().max()) < 1e-3


def test_multiscale_ncc(scene):
    from diffdrr_tpu_torch.metrics import MultiscaleNormalizedCrossCorrelation2d

    x = torch.rand(3, 1, 20, 20, generator=torch.Generator().manual_seed(0))
    y = x.flip(-1) + 0.1 * torch.rand(3, 1, 20, 20, generator=torch.Generator().manual_seed(1))
    got = MultiscaleNormalizedCrossCorrelation2d([None, 13], [0.5, 0.5])(x, y)
    want = ncc.multiscale_ncc(x.double(), y.double())
    assert torch.allclose(got.double(), want, atol=1e-5)


def test_density_gradient(scene):
    subject, geo, density = scene
    drr = _drr(subject, "siddon")
    from diffdrr_tpu_torch.pose import convert

    src, tgt = drr.detector(convert(ROT, TRANS, **KW))
    d = drr.density.clone().requires_grad_(True)
    g_img = torch.linspace(-1, 1, 2 * 144).reshape(2, 1, 144)
    (got,) = torch.autograd.grad((drr.render(d, src, tgt) * g_img).sum(), d)
    s, t, w = geo.rays(ROT.double(), TRANS.double())
    want = torch.zeros(density.numel(), dtype=torch.float64)
    render.siddon_density_grad(SHAPE, s.expand_as(t).reshape(-1, 3), t.reshape(-1, 3),
                               w.reshape(-1), g_img.reshape(-1).double(), want)
    want = want.reshape(SHAPE)
    # float32 sums of signed terms against float64
    assert float((got.double() - want).abs().max() / want.abs().max()) < 1e-4
