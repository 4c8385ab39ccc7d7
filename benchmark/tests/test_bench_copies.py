"""The frozen copies in ``benchmark/`` held to their sources in the program
at a tiny size: the phantom recipe, the work and cost counts of a render,
and the window arithmetic."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import geometry, phantom, render
from benchmark.yardstick import cost, window

SHAPE, SPACING = (24, 20, 10), (4.0, 4.0, 10.0)


def test_phantom_is_the_recipe():
    from scipy import ndimage

    from diffdrr_tpu_torch.data import _chest_phantom

    seed = 5
    hu_np, labels = _chest_phantom(SHAPE, seed=seed)
    low = np.random.default_rng(seed).normal(0.0, 12.0, (8, 8, 4)).astype(np.float32)
    # The recipe's tissue classes exactly; its upsampled variation to float32 rounding.
    base = phantom.chest_hu(SHAPE, torch.zeros(8, 8, 4)).numpy()
    noise = ndimage.zoom(low, (SHAPE[0] / 8, SHAPE[1] / 8, SHAPE[2] / 4), order=1)
    assert np.array_equal(base + noise * (labels > 0), hu_np)
    got = phantom.chest_hu(SHAPE, torch.from_numpy(low)).numpy()
    assert np.abs(got - hu_np).max() < 1e-3


@pytest.mark.parametrize("renderer,n_points", [("siddon", None), ("trilinear", 500),
                                               ("trilinear", 9)])
def test_cost_is_render_cost(renderer, n_points):
    from diffdrr_tpu_torch import DRR
    from diffdrr_tpu_torch.data import Image, read
    from diffdrr_tpu_torch.pose import convert
    from diffdrr_tpu_torch.profiling import render_cost

    hu = phantom.chest_hu(SHAPE, torch.zeros(8, 8, 4))
    subject = read(Image(hu.numpy(), np.diag([*SPACING, 1.0])), orientation="AP")
    subject.to("cpu")
    rot = torch.tensor([[0.01, math.pi / 2 + 0.02, -0.01], [0.03, math.pi / 2 - 0.01, 0.02]])
    trans = torch.tensor([[0.0, 850.0, 0.0], [5.0, 840.0, -3.0]])
    kw = {} if n_points is None else {"n_points": n_points}
    drr = DRR(subject, sdd=1020.0, height=16, delx=10.0, renderer=renderer, device="cpu", **kw)
    geo = geometry.Geometry(sdd=1020.0, height=16, width=16, delx=10.0, dely=10.0,
                            shape=SHAPE, spacing=SPACING)
    src, tgt, _ = geo.rays(rot.double(), trans.double())
    axis = geo.march_axis(rot.double(), trans.double())[0]
    want = render_cost(drr, axis=axis, pose=convert(rot, trans, parameterization="euler_angles",
                                                    convention="ZXY"))
    if renderer == "siddon":
        work = cost.siddon_work(src, tgt, SHAPE, axis)
    else:
        h, n_steps = render.march_steps(SHAPE[axis], n_points)
        work = cost.joseph_work(src, tgt, SHAPE, axis, h, n_steps)
        assert work.blend == (n_points < SHAPE[axis])
    assert cost.kernel_cost(work, "fwd") == (want.bytes, want.flops)


def test_window_arithmetic_is_bench_window():
    from diffdrr_tpu_torch import bench

    rot0 = torch.zeros(1, 3)
    out = bench.window(lambda rot, iters: rot.sum() * iters, rot0, iters=3, windows=2)
    host = [t * 3 for t in out["windows_s"]]
    assert window.seconds_per_iteration(host, out["iterations"]) == pytest.approx(out["s"])
    assert window.rate(10.0, 4.0) == 2.5
    assert window.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
