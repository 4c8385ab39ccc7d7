"""Joseph plane-march kernels: wrappers, plain versions, autograd.

Counterpart of ``diffdrr_tpu/ops/pallas/joseph.py``, which also carries the
trilinear renderer (``raymarch.py`` here maps ``n_points`` to a stride). The
rays are packed by ``prep_rays(..., quadrature="joseph", h=h)``; the march
samples each ray at axis positions ``k = p * h``, ``p`` in ``[0, n_steps)``:
a bilinear sample of plane ``k`` for an integer ``h``, a lerp of the
bracketing planes for a fractional one (``csrc/joseph.cuh`` says how). Five
functions of the rows and the density:

  * ``joseph_fwd(rows, density, axis, h, n_steps) -> (R,)``: the line
    integrals, the sum mode of the TPU's ``_fwd_kernel`` and the function
    of ``_fwd_plane_major_kernel``;
  * ``joseph_fwd_max(...) -> ((R,), (R,) int32)``: the MIP value and its
    argmax step (-1 for none), the max mode of ``_fwd_kernel``;
  * ``joseph_fwdgrad(..., reduce="sum"|"max") -> ((8, R), arg)``: the 7
    gradient rows d(value)/d(a, b, gy, dy, gz, dz, sc), then the value, in
    one march, the function of ``_fwdgrad_kernel``; under max the rows are
    the argmax step's, and ``arg`` the argmax (None in sum mode);
  * ``joseph_bwd_rays(..., g, arg=None) -> (7, R)``: g * the gradient rows,
    gated to the argmax step in MIP, the function of ``_bwd_rays_kernel``
    (in sum mode ``joseph_fwdgrad``'s rows times g, bit for bit);
  * ``joseph_bwd_vol(rows, g, shape, axis, h, n_steps, arg=None) -> shape``:
    the density gradient, the function of ``_bwd_vol_kernel``.

and three in channel mode (``mask_to_channels``), where ``labels`` is an
int32 labelmap of the density's shape and each step lands in the channel of
its sample's nearest-voxel label (``label_at`` in ``csrc/joseph.cuh``; a
label outside ``[0, C)`` adds nothing):

  * ``joseph_fwd_ch(rows, density, labels, axis, h, n_steps, n_channels)
    -> (C, R)``: the per-channel sums, ``_fwd_kernel`` with ``n_ch``;
  * ``joseph_bwd_rays_ch(rows, density, labels, axis, h, n_steps, g (C, R))
    -> (7, R)``: each step's terms times the cotangent of its channel,
    ``_bwd_rays_kernel`` with ``n_ch``;
  * ``joseph_bwd_vol_ch(rows, g, labels, shape, axis, h, n_steps) -> shape``:
    ``_bwd_vol_kernel`` with ``n_ch``.

Each wrapper launches its CUDA kernel (``csrc/joseph.cu``) on a CUDA tensor
and counts the launch in its ``launches`` attribute; on a CPU tensor it runs
the plain PyTorch version beside it, which repeats the kernel's arithmetic
one step at a time for all rays. Any other device raises; so does a build or
launch failure. There is no fallback from the kernel to the plain version.

The six that read the density take ``storage``: under ``"bf16"`` they
launch the kernel's bf16 instantiation on the bf16 bricked copy (counted in
``launches_bf16``; the MIP backward too reads that copy), and the plain
versions read the density rounded to bf16 (``_launch.stored``): the float32
function of the rounded density, bit for bit. The scatters read no density
and have no storage; the labelmap's copy keeps its int32 bits.

``h`` is a Python float; the kernels take its float32 rounding and march
fractionally when ``|h - round(h)| > 1e-9``, the TPU's blend test.

``JosephMarch`` is the autograd boundary, in sum or max mode, and
``JosephMarchChannels`` in channel mode (always a sum, never the fused
forward, as on the TPU). Each computes each gradient only when autograd
asks for it; the rows amin/amax get zero cotangents (they enter only
through the in-slab comparison).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ._launch import (call, check, check_cotangent, check_rows, count_launch, ptr,
                      runs_plain, stored, strides_extents)
from .brick import bricked
from .prep import NROWS, ROW_NAMES, march_perm, prep_rays

__all__ = [
    "joseph_fwd", "joseph_fwd_max", "joseph_fwdgrad", "joseph_bwd_rays", "joseph_bwd_vol",
    "joseph_fwd_plain", "joseph_fwd_max_plain", "joseph_fwdgrad_plain",
    "joseph_bwd_rays_plain", "joseph_bwd_vol_plain",
    "joseph_fwd_ch", "joseph_bwd_rays_ch", "joseph_bwd_vol_ch",
    "joseph_fwd_ch_plain", "joseph_bwd_rays_ch_plain", "joseph_bwd_vol_ch_plain",
    "JosephMarch", "JosephMarchChannels", "joseph_march_raycast", "is_blend", "march_steps",
    "corners", "as_labels", "reset_launch_counts",
]

GRAD_ROWS = 7
FUSED_ROWS = GRAD_ROWS + 1


def is_blend(h: float) -> bool:
    """A fractional stride: the march lerps plane pairs."""
    return abs(h - round(h)) > 1e-9


# -----------------------------------------------------------------------------
# Plain PyTorch versions (all rays at once, one step at a time)
# -----------------------------------------------------------------------------


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in float32)."""
    return float(np.float32(x))


def _tent(u):
    return torch.clamp(1.0 - torch.abs(u), min=0.0)


def _tent_d(u):
    return torch.where(torch.abs(u) < 1.0, -torch.sign(u), torch.zeros_like(u))


def _rows_dict(rows):
    return dict(zip(ROW_NAMES, rows.unbind(0)))


def march_steps(rows: torch.Tensor, h: float, X: int, n_steps: int, derivs: bool = False):
    """Each step of the march for all rays (``step_at`` in ``csrc/joseph.cuh``).

    Yields one dict per step ``p`` in ``[0, n_steps)``: ``p``, the axis
    position ``k``, ``alpha``, the transverse position ``y``, ``z`` and its
    floors ``fy``, ``fz``, ``inslab``, ``scale`` (``sc`` inside the slab),
    the tent weights ``wy``, ``wz`` of the neighbours floor and floor + 1
    (with ``derivs``, their derivatives ``dy``, ``dz``), and ``planes``: the
    ``(plane, weight)`` pairs the step reads, ``(k, 1.0)`` at an integer
    ``h`` and ``(k0, 1 - fx), (k0 + 1, fx)`` at a fractional one.
    """
    r = _rows_dict(rows)
    blend = is_blend(h)
    for p in range(n_steps):
        k = _f32(np.float32(p) * np.float32(h))
        alpha = k * r["a"] + r["b"]
        inslab = (alpha >= r["amin"]) & (alpha <= r["amax"])
        if blend:
            k0 = min(max(float(np.floor(k)), 0.0), float(X - 1))
            fx = _f32(np.float32(k) - np.float32(k0))
            planes = [(int(k0), _f32(np.float32(1.0) - np.float32(fx))), (int(k0) + 1, fx)]
        else:
            planes = [(p * int(round(h)), 1.0)]
        y = r["gy"] + alpha * r["dy"]
        z = r["gz"] + alpha * r["dz"]
        fy, fz = torch.floor(y), torch.floor(z)
        uy, uz = y - fy, z - fz
        s = dict(p=p, k=k, alpha=alpha, y=y, z=z, inslab=inslab,
                 scale=torch.where(inslab, r["sc"], torch.zeros_like(alpha)),
                 planes=planes, fy=fy, fz=fz,
                 wy=(_tent(uy), _tent(uy - 1.0)), wz=(_tent(uz), _tent(uz - 1.0)))
        if derivs:
            s["dy"] = (_tent_d(uy), _tent_d(uy - 1.0))
            s["dz"] = (_tent_d(uz), _tent_d(uz - 1.0))
        yield s


def corners(s):
    """The step's 2 x 2 in-plane neighbours, ``(m, n, fy + m, fz + n)``."""
    for m in range(2):
        for n in range(2):
            yield m, n, s["fy"] + float(m), s["fz"] + float(n)


def _plane_values(vol_p, k: int, fy, fz):
    """vol_p[k, fy, fz] at integer-valued float positions; 0 outside."""
    X, Y, Z = vol_p.shape
    if not 0 <= k < X:
        return torch.zeros_like(fy)
    valid = (fy >= 0) & (fy < Y) & (fz >= 0) & (fz < Z)
    iy = torch.clamp(fy, 0, Y - 1).to(torch.int64)
    iz = torch.clamp(fz, 0, Z - 1).to(torch.int64)
    return torch.where(valid, vol_p[k][iy, iz], torch.zeros_like(fy))


def _window(vol_p, s):
    """win[m][n] at (fy + m, fz + n), lerped over the plane pair in blend mode."""
    win = [[None, None], [None, None]]
    for m, n, fy, fz in corners(s):
        w = [_plane_values(vol_p, k, fy, fz) * f for k, f in s["planes"]]
        win[m][n] = w[0] if len(w) == 1 else w[0] + w[1]
    return win


def _bilinear(s, win):
    wy, wz = s["wy"], s["wz"]
    t4a = win[0][0] * wz[0] + win[0][1] * wz[1]
    t4b = win[1][0] * wz[0] + win[1][1] * wz[1]
    return wy[0] * t4a + wy[1] * t4b


def _terms(r, s, win):
    """The step's 7 gradient terms and its value (``step_terms``)."""
    wy, wz, dy, dz = s["wy"], s["wz"], s["dy"], s["dz"]
    t4a = win[0][0] * wz[0] + win[0][1] * wz[1]
    t4b = win[1][0] * wz[0] + win[1][1] * wz[1]
    t3a = win[0][0] * dz[0] + win[0][1] * dz[1]
    t3b = win[1][0] * dz[0] + win[1][1] * dz[1]
    dry = (dy[0] * t4a + dy[1] * t4b) * s["scale"]
    drz = (wy[0] * t3a + wy[1] * t3b) * s["scale"]
    dsc = torch.where(s["inslab"], wy[0] * t4a + wy[1] * t4b, torch.zeros_like(t4a))
    dalpha = dry * r["dy"] + drz * r["dz"]
    terms = (dalpha * s["k"], dalpha, dry, dry * s["alpha"], drz, drz * s["alpha"], dsc)
    return terms, dsc * s["scale"]


@torch.no_grad()
def joseph_fwd_plain(rows: torch.Tensor, density: torch.Tensor, axis: int, h: float,
                     n_steps: int, storage=None) -> torch.Tensor:
    """Plain version of :func:`joseph_fwd` (and of every wrapper's ``storage``:
    the density rounded to bf16 under ``"bf16"``)."""
    vol_p = stored(density, storage).permute(march_perm(axis))
    acc = torch.zeros_like(rows[0])
    for s in march_steps(rows, h, vol_p.shape[0], n_steps):
        acc = acc + _bilinear(s, _window(vol_p, s)) * s["scale"]
    return acc


@torch.no_grad()
def joseph_fwd_max_plain(rows: torch.Tensor, density: torch.Tensor, axis: int, h: float,
                         n_steps: int, storage=None):
    """Plain version of :func:`joseph_fwd_max`: (value, int32 argmax step)."""
    vol_p = stored(density, storage).permute(march_perm(axis))
    best = torch.zeros_like(rows[0])
    arg = torch.full(best.shape, -1, dtype=torch.int32, device=best.device)
    for s in march_steps(rows, h, vol_p.shape[0], n_steps):
        x = _bilinear(s, _window(vol_p, s)) * s["scale"]
        better = x > best
        arg = torch.where(better, torch.full_like(arg, s["p"]), arg)
        best = torch.where(better, x, best)
    return best, arg


@torch.no_grad()
def joseph_fwdgrad_plain(rows: torch.Tensor, density: torch.Tensor, axis: int, h: float,
                         n_steps: int, reduce: str = "sum", storage=None):
    """Plain version of :func:`joseph_fwdgrad`: ((8, R), argmax or None)."""
    r = _rows_dict(rows)
    vol_p = stored(density, storage).permute(march_perm(axis))
    acc = [torch.zeros_like(r["a"]) for _ in range(FUSED_ROWS)]
    arg = torch.full(acc[0].shape, -1, dtype=torch.int32, device=acc[0].device)
    for s in march_steps(rows, h, vol_p.shape[0], n_steps, derivs=True):
        terms, contrib = _terms(r, s, _window(vol_p, s))
        new = terms + (contrib,)
        if reduce == "max":
            better = contrib > acc[GRAD_ROWS]
            acc = [torch.where(better, t, a) for a, t in zip(acc, new)]
            arg = torch.where(better, torch.full_like(arg, s["p"]), arg)
        else:
            acc = [a + t for a, t in zip(acc, new)]
    return torch.stack(acc), (arg if reduce == "max" else None)


@torch.no_grad()
def joseph_bwd_rays_plain(rows: torch.Tensor, density: torch.Tensor, axis: int, h: float,
                          n_steps: int, g: torch.Tensor, arg=None,
                          storage=None) -> torch.Tensor:
    """Plain version of :func:`joseph_bwd_rays`: (7, R)."""
    r = _rows_dict(rows)
    vol_p = stored(density, storage).permute(march_perm(axis))
    acc = [torch.zeros_like(r["a"]) for _ in range(GRAD_ROWS)]
    for s in march_steps(rows, h, vol_p.shape[0], n_steps, derivs=True):
        terms, _ = _terms(r, s, _window(vol_p, s))
        if arg is not None:
            terms = [torch.where(arg == s["p"], t, torch.zeros_like(t)) for t in terms]
        acc = [a + t for a, t in zip(acc, terms)]
    return torch.stack(acc) * g


def _scatter_step(grad_p, s, gp) -> None:
    """One step's share of the density gradient (``step_adds``), added
    into the march-permuted view ``grad_p``."""
    X, Y, Z = grad_p.shape
    for m, n, fy, fz in corners(s):
        x = (s["wy"][m] * gp) * (s["wz"][n] * s["scale"])
        ok = s["inslab"] & (fy >= 0) & (fy < Y) & (fz >= 0) & (fz < Z)
        iy = torch.clamp(fy, 0, Y - 1).to(torch.int64)
        iz = torch.clamp(fz, 0, Z - 1).to(torch.int64)
        for k, f in s["planes"]:
            if 0 <= k < X:
                xk = x * f
                grad_p[k].index_put_((iy, iz), torch.where(ok, xk, torch.zeros_like(xk)),
                                     accumulate=True)


@torch.no_grad()
def joseph_bwd_vol_plain(rows: torch.Tensor, g: torch.Tensor, shape, axis: int, h: float,
                         n_steps: int, arg=None) -> torch.Tensor:
    """Plain version of :func:`joseph_bwd_vol`: a float32 volume of ``shape``."""
    grad = torch.zeros(tuple(shape), dtype=torch.float32, device=rows.device)
    grad_p = grad.permute(march_perm(axis))  # a view: writes land in ``grad``
    for s in march_steps(rows, h, grad_p.shape[0], n_steps):
        _scatter_step(grad_p, s, g if arg is None else
                      torch.where(arg == s["p"], g, torch.zeros_like(g)))
    return grad


def _labels_at(lab_p: torch.Tensor, s) -> torch.Tensor:
    """Each ray's label at the step's nearest voxel (``label_at``), int32.

    ``lab_p`` is the labelmap in march order. The transverse position rounds
    half to even (``torch.round``, as ``rintf``); the plane is the step's, or
    at a fractional stride the pair's second plane only when ``fx > 0.5``.
    Positions outside the volume, plane X included, read 0.
    """
    X, Y, Z = lab_p.shape
    (k, _), *pair = s["planes"]
    if pair and pair[0][1] > 0.5:
        k = pair[0][0]
    iy, iz = torch.round(s["y"]), torch.round(s["z"])
    if not 0 <= k < X:
        return torch.zeros(iy.shape, dtype=torch.int32, device=iy.device)
    valid = (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
    lab = lab_p[k][torch.clamp(iy, 0, Y - 1).to(torch.int64),
                   torch.clamp(iz, 0, Z - 1).to(torch.int64)]
    return torch.where(valid, lab, torch.zeros_like(lab))


def _channel_cotangent(g: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """``g[lab, r]`` for each ray ``r`` of a ``(C, R)`` cotangent; 0 where the
    label is outside ``[0, C)``."""
    ok = (lab >= 0) & (lab < g.shape[0])
    gc = torch.gather(g, 0, torch.clamp(lab, 0, g.shape[0] - 1).to(torch.int64)[None])[0]
    return torch.where(ok, gc, torch.zeros_like(gc))


@torch.no_grad()
def joseph_fwd_ch_plain(rows: torch.Tensor, density: torch.Tensor, labels: torch.Tensor,
                        axis: int, h: float, n_steps: int, n_channels: int,
                        storage=None) -> torch.Tensor:
    """Plain version of :func:`joseph_fwd_ch`: ``(C, R)``."""
    vol_p = stored(density, storage).permute(march_perm(axis))
    lab_p = labels.permute(march_perm(axis))
    acc = rows.new_zeros((n_channels, rows.shape[1]))
    chans = torch.arange(n_channels, device=rows.device)[:, None]
    for s in march_steps(rows, h, vol_p.shape[0], n_steps):
        x = _bilinear(s, _window(vol_p, s)) * s["scale"]
        lab = _labels_at(lab_p, s)
        lab = torch.where(s["scale"] > 0.0, lab, torch.full_like(lab, -1))
        acc = torch.where(lab == chans, acc + x, acc)
    return acc


@torch.no_grad()
def joseph_bwd_rays_ch_plain(rows: torch.Tensor, density: torch.Tensor, labels: torch.Tensor,
                             axis: int, h: float, n_steps: int, g: torch.Tensor,
                             storage=None) -> torch.Tensor:
    """Plain version of :func:`joseph_bwd_rays_ch`: ``(7, R)``."""
    r = _rows_dict(rows)
    vol_p = stored(density, storage).permute(march_perm(axis))
    lab_p = labels.permute(march_perm(axis))
    acc = [torch.zeros_like(r["a"]) for _ in range(GRAD_ROWS)]
    for s in march_steps(rows, h, vol_p.shape[0], n_steps, derivs=True):
        terms, _ = _terms(r, s, _window(vol_p, s))
        gc = _channel_cotangent(g, _labels_at(lab_p, s))
        acc = [a + t * gc for a, t in zip(acc, terms)]
    return torch.stack(acc)


@torch.no_grad()
def joseph_bwd_vol_ch_plain(rows: torch.Tensor, g: torch.Tensor, labels: torch.Tensor, shape,
                            axis: int, h: float, n_steps: int) -> torch.Tensor:
    """Plain version of :func:`joseph_bwd_vol_ch`: a float32 volume of ``shape``."""
    grad = torch.zeros(tuple(shape), dtype=torch.float32, device=rows.device)
    grad_p = grad.permute(march_perm(axis))
    lab_p = labels.permute(march_perm(axis))
    for s in march_steps(rows, h, grad_p.shape[0], n_steps):
        _scatter_step(grad_p, s, _channel_cotangent(g, _labels_at(lab_p, s)))
    return grad


# -----------------------------------------------------------------------------
# Wrappers: the CUDA kernel on a CUDA tensor, the plain version on the CPU
# -----------------------------------------------------------------------------


def _check_march(h: float, n_steps: int) -> None:
    if not h > 0.0:
        raise ValueError(f"the stride h must be positive, not {h}")
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, not {n_steps}")


def _march(h: float, n_steps: int) -> list:
    return [float(h), int(n_steps), int(is_blend(h))]


def joseph_fwd(rows: torch.Tensor, density: torch.Tensor, axis: int, h: float,
               n_steps: int, storage=None) -> torch.Tensor:
    """Line integrals ``(R,)`` of the rays ``rows (9, R)`` through ``density``.
    The kernel reads the density's bricked copy (``brick.bricked``: made
    once for an unchanged density), bf16 under ``storage="bf16"``; a float32
    launch at a fractional ``h`` also counts in ``launches_blend``."""
    check("joseph", rows, density, axis, storage)
    _check_march(h, n_steps)
    if runs_plain("joseph_fwd", rows):
        return joseph_fwd_plain(rows, density, axis, h, n_steps, storage)
    vol = bricked(density, storage)
    rows = rows.contiguous()
    out = torch.empty(rows.shape[1], dtype=torch.float32, device=rows.device)
    call("joseph", vol.entry("joseph_fwd"), rows.device, rows.data_ptr(), rows.shape[1],
         vol.data.data_ptr(), *vol.args(axis), *_march(h, n_steps), out.data_ptr())
    count_launch(joseph_fwd, storage)
    if storage is None and is_blend(h):
        joseph_fwd.launches_blend += 1
    return out


def joseph_fwd_max(rows: torch.Tensor, density: torch.Tensor, axis: int, h: float,
                   n_steps: int, storage=None):
    """MIP ``(value (R,), argmax (R,) int32)``: the largest sample * sc over
    each ray's steps and its step (-1: none beat 0). The kernel reads the
    density's bricked copy, as ``joseph_fwd`` does, with several lanes a
    ray."""
    check("joseph", rows, density, axis, storage)
    _check_march(h, n_steps)
    if runs_plain("joseph_fwd_max", rows):
        return joseph_fwd_max_plain(rows, density, axis, h, n_steps, storage)
    vol = bricked(density, storage)
    rows = rows.contiguous()
    val = torch.empty(rows.shape[1], dtype=torch.float32, device=rows.device)
    arg = torch.empty(rows.shape[1], dtype=torch.int32, device=rows.device)
    call("joseph", vol.entry("joseph_fwd_max"), rows.device, rows.data_ptr(), rows.shape[1],
         vol.data.data_ptr(), *vol.args(axis), *_march(h, n_steps), val.data_ptr(),
         arg.data_ptr())
    count_launch(joseph_fwd_max, storage)
    return val, arg


def joseph_fwdgrad(rows: torch.Tensor, density: torch.Tensor, axis: int, h: float,
                   n_steps: int, reduce: str = "sum", storage=None):
    """``((8, R), arg)``: the 7 gradient rows and the value; in max mode the
    argmax step's rows and the MIP value, and ``arg`` the argmax (else None).
    The kernel reads the density's bricked copy, as ``joseph_fwd`` does, with
    several lanes a ray; its rows are the same on every run."""
    check("joseph", rows, density, axis, storage)
    _check_march(h, n_steps)
    if reduce not in ("sum", "max"):
        raise ValueError(f"reduce must be 'sum' or 'max', not {reduce!r}")
    if runs_plain("joseph_fwdgrad", rows):
        return joseph_fwdgrad_plain(rows, density, axis, h, n_steps, reduce, storage)
    vol = bricked(density, storage)
    rows = rows.contiguous()
    out = torch.empty((FUSED_ROWS, rows.shape[1]), dtype=torch.float32, device=rows.device)
    arg = (torch.empty(rows.shape[1], dtype=torch.int32, device=rows.device)
           if reduce == "max" else None)
    call("joseph", vol.entry("joseph_fwdgrad"), rows.device, rows.data_ptr(), rows.shape[1],
         vol.data.data_ptr(), *vol.args(axis), *_march(h, n_steps), out.data_ptr(), ptr(arg))
    count_launch(joseph_fwdgrad, storage)
    return out, arg


def joseph_bwd_rays(rows: torch.Tensor, density: torch.Tensor, axis: int, h: float,
                    n_steps: int, g: torch.Tensor, arg=None, storage=None) -> torch.Tensor:
    """``(7, R)``: g * d(value)/d(row); MIP when the argmax ``arg`` is given.
    In sum mode the kernel reads the density's bricked copy, which the
    forward of the same density has made (so the two-pass backward makes
    none), with several lanes a ray: its rows are ``joseph_fwdgrad``'s rows
    0-6 times g bit for bit. In MIP (one step a ray) it runs one thread per
    ray on the density itself, or under bf16 storage on the bf16 bricked
    copy that the MIP forward made (the rounded values, with no second
    copy)."""
    check("joseph", rows, density, axis, storage)
    _check_march(h, n_steps)
    g = check_cotangent(rows, g, arg)
    if runs_plain("joseph_bwd_rays", rows):
        return joseph_bwd_rays_plain(rows, density, axis, h, n_steps, g, arg, storage)
    rows = rows.contiguous()
    out = torch.empty((GRAD_ROWS, rows.shape[1]), dtype=torch.float32, device=rows.device)
    if arg is None or storage is not None:
        vol = bricked(density, storage)
        mip = [] if arg is None else [arg.data_ptr()]
        call("joseph", vol.entry("joseph_bwd_rays" + ("_mip" if mip else "")), rows.device,
             rows.data_ptr(), rows.shape[1], vol.data.data_ptr(), *vol.args(axis),
             *_march(h, n_steps), g.data_ptr(), *mip, out.data_ptr())
    else:
        call("joseph", "joseph_bwd_rays_mip", rows.device, rows.data_ptr(), rows.shape[1],
             density.data_ptr(), *strides_extents(density, axis), *_march(h, n_steps),
             g.data_ptr(), arg.data_ptr(), out.data_ptr())
    count_launch(joseph_bwd_rays, storage)
    return out


def joseph_bwd_vol(rows: torch.Tensor, g: torch.Tensor, shape, axis: int, h: float,
                   n_steps: int, arg=None) -> torch.Tensor:
    """d(loss)/d(density): a contiguous float32 volume of the density's
    ``shape``; MIP when the argmax ``arg`` is given. The kernel adds with
    float atomics, so its last bits vary from run to run."""
    check_rows("joseph", rows, axis)
    _check_march(h, n_steps)
    g = check_cotangent(rows, g, arg)
    if len(shape) != 3:
        raise ValueError(f"shape must be (X, Y, Z), got {tuple(shape)}")
    if runs_plain("joseph_bwd_vol", rows):
        return joseph_bwd_vol_plain(rows, g, shape, axis, h, n_steps, arg)
    rows = rows.contiguous()
    grad = torch.zeros(tuple(shape), dtype=torch.float32, device=rows.device)
    call("joseph", "joseph_bwd_vol", rows.device, rows.data_ptr(), rows.shape[1], g.data_ptr(),
         ptr(arg), grad.data_ptr(), *strides_extents(grad, axis), *_march(h, n_steps))
    joseph_bwd_vol.launches += 1
    return grad


def as_labels(mask: torch.Tensor) -> torch.Tensor:
    """A labelmap as the channel kernels take it: int32 (float labels rounded)."""
    if mask.is_floating_point():
        mask = torch.round(mask)
    return mask.to(torch.int32)


def _check_labels(labels: torch.Tensor, shape, device) -> None:
    if labels.dtype != torch.int32 or tuple(labels.shape) != tuple(shape) \
            or labels.device != device:
        raise ValueError(f"labels must be int32 {tuple(shape)} on {device}, got "
                         f"{labels.dtype} {tuple(labels.shape)} on {labels.device}")


def _lab_strides(labels: torch.Tensor, axis: int) -> list:
    """The labelmap's element strides in march order (its extents are the density's)."""
    return strides_extents(labels, axis)[:3]


def _check_channel_cotangent(rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g`` as a contiguous (C, R) float32 tensor."""
    R = rows.shape[1]
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[1] != R or g.shape[0] < 1 \
            or g.device != rows.device:
        raise ValueError(f"g must be float32 (C, {R}) on {rows.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    return g.contiguous()


def joseph_fwd_ch(rows: torch.Tensor, density: torch.Tensor, labels: torch.Tensor, axis: int,
                  h: float, n_steps: int, n_channels: int, storage=None) -> torch.Tensor:
    """Per-channel line integrals ``(C, R)``: each sample * sc added to the
    channel of its nearest-voxel label. The kernel reads the bricked copies
    of the density (bf16 under ``storage="bf16"``) and of the labelmap
    (``brick.bricked``), the copies that ``joseph_bwd_rays_ch`` reads, so a
    render and its pose backward make each once."""
    check("joseph", rows, density, axis, storage)
    _check_march(h, n_steps)
    _check_labels(labels, density.shape, rows.device)
    if n_channels < 1:
        raise ValueError(f"n_channels must be >= 1, not {n_channels}")
    if runs_plain("joseph_fwd_ch", rows):
        return joseph_fwd_ch_plain(rows, density, labels, axis, h, n_steps, n_channels, storage)
    vol, lab = bricked(density, storage), bricked(labels)
    rows = rows.contiguous()
    out = torch.empty((n_channels, rows.shape[1]), dtype=torch.float32, device=rows.device)
    call("joseph", vol.entry("joseph_fwd_ch"), rows.device, rows.data_ptr(), rows.shape[1],
         vol.data.data_ptr(), lab.data.data_ptr(), *vol.args(axis), *_march(h, n_steps),
         int(n_channels), out.data_ptr())
    count_launch(joseph_fwd_ch, storage)
    return out


def joseph_bwd_rays_ch(rows: torch.Tensor, density: torch.Tensor, labels: torch.Tensor,
                       axis: int, h: float, n_steps: int, g: torch.Tensor,
                       storage=None) -> torch.Tensor:
    """``(7, R)``: d(sum of g * image)/d(row) for a ``(C, R)`` cotangent ``g``.
    The kernel reads the bricked copies of the density and of the labelmap
    (``brick.bricked``: each made once while it is unchanged) with several
    lanes a ray, as ``joseph_fwdgrad`` does; its rows are the same on every
    run."""
    check("joseph", rows, density, axis, storage)
    _check_march(h, n_steps)
    _check_labels(labels, density.shape, rows.device)
    g = _check_channel_cotangent(rows, g)
    if runs_plain("joseph_bwd_rays_ch", rows):
        return joseph_bwd_rays_ch_plain(rows, density, labels, axis, h, n_steps, g, storage)
    vol, lab = bricked(density, storage), bricked(labels)
    rows = rows.contiguous()
    out = torch.empty((GRAD_ROWS, rows.shape[1]), dtype=torch.float32, device=rows.device)
    call("joseph", vol.entry("joseph_bwd_rays_ch"), rows.device, rows.data_ptr(), rows.shape[1],
         vol.data.data_ptr(), lab.data.data_ptr(), *vol.args(axis), *_march(h, n_steps),
         g.shape[0], g.data_ptr(), out.data_ptr())
    count_launch(joseph_bwd_rays_ch, storage)
    return out


def joseph_bwd_vol_ch(rows: torch.Tensor, g: torch.Tensor, labels: torch.Tensor, shape,
                      axis: int, h: float, n_steps: int) -> torch.Tensor:
    """d(sum of g * image)/d(density) for a ``(C, R)`` cotangent ``g``: a
    contiguous float32 volume of ``shape`` (float atomics, as
    :func:`joseph_bwd_vol`)."""
    check_rows("joseph", rows, axis)
    _check_march(h, n_steps)
    if len(shape) != 3:
        raise ValueError(f"shape must be (X, Y, Z), got {tuple(shape)}")
    _check_labels(labels, shape, rows.device)
    g = _check_channel_cotangent(rows, g)
    if runs_plain("joseph_bwd_vol_ch", rows):
        return joseph_bwd_vol_ch_plain(rows, g, labels, shape, axis, h, n_steps)
    rows = rows.contiguous()
    grad = torch.zeros(tuple(shape), dtype=torch.float32, device=rows.device)
    call("joseph", "joseph_bwd_vol_ch", rows.device, rows.data_ptr(), rows.shape[1],
         g.data_ptr(), labels.data_ptr(), *_lab_strides(labels, axis), grad.data_ptr(),
         *strides_extents(grad, axis), *_march(h, n_steps), g.shape[0])
    joseph_bwd_vol_ch.launches += 1
    return grad


KERNELS = (joseph_fwd, joseph_fwd_max, joseph_fwdgrad, joseph_bwd_rays, joseph_bwd_vol,
           joseph_fwd_ch, joseph_bwd_rays_ch, joseph_bwd_vol_ch)
# The wrappers with a bf16 instantiation (those that read the density).
BF16_KERNELS = (joseph_fwd, joseph_fwd_max, joseph_fwdgrad, joseph_bwd_rays, joseph_fwd_ch,
                joseph_bwd_rays_ch)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in BF16_KERNELS:
        fn.launches_bf16 = 0
    # Of joseph_fwd's float32 launches, those at a fractional stride (blend mode).
    joseph_fwd.launches_blend = 0


reset_launch_counts()


# -----------------------------------------------------------------------------
# Autograd
# -----------------------------------------------------------------------------


class JosephMarch(torch.autograd.Function):
    """``value (R,) = joseph(density, rows)``, by sum or by max (MIP).

    Forward: ``joseph_fwdgrad`` (in the reduce mode) when the rays need a
    gradient and ``fused`` (their backward is then ``rows * g``), else
    ``joseph_fwd`` or ``joseph_fwd_max``; the max modes keep the argmax,
    which gates the backward. Backward: the rays' cotangent from the fused
    rows or ``joseph_bwd_rays`` (zero for amin/amax), the density's from
    ``joseph_bwd_vol``, each only when asked for. In sum mode
    ``joseph_bwd_rays`` reads the bricked copy that ``joseph_fwd`` made, and
    the fused and the two-pass pose gradients agree to the last bit.
    ``storage`` is the density copy's element type; the density's gradient
    stays float32 (straight through the rounding).
    """

    @staticmethod
    def forward(ctx, density, rows, axis, h, n_steps, reduce="sum", fused=True, storage=None):
        if reduce not in ("sum", "max"):
            raise ValueError(f"reduce must be 'sum' or 'max', not {reduce!r}")
        ray_grad = ctx.needs_input_grad[1]
        ctx.march = (axis, h, n_steps)
        ctx.shape, ctx.storage = tuple(density.shape), storage
        ctx.fused = fused and ray_grad
        arg = grad_rows = None
        if ctx.fused:
            allrows, arg = joseph_fwdgrad(rows, density, axis, h, n_steps, reduce, storage)
            out, grad_rows = allrows[GRAD_ROWS], allrows[:GRAD_ROWS]
        elif reduce == "max":
            out, arg = joseph_fwd_max(rows, density, axis, h, n_steps, storage)
        else:
            out = joseph_fwd(rows, density, axis, h, n_steps, storage)
        # joseph_bwd_rays re-reads the density; the other backwards need only rows.
        ctx.save_for_backward(rows, density if ray_grad and not ctx.fused else None,
                              arg, grad_rows)
        return out

    @staticmethod
    def backward(ctx, g):
        rows, density, arg, grad_rows = ctx.saved_tensors
        axis, h, n_steps = ctx.march
        d_density = d_rows = None
        if ctx.needs_input_grad[1]:
            d7 = (grad_rows * g if ctx.fused
                  else joseph_bwd_rays(rows, density, axis, h, n_steps, g, arg, ctx.storage))
            d_rows = torch.cat([d7, d7.new_zeros((NROWS - GRAD_ROWS, d7.shape[1]))])
        if ctx.needs_input_grad[0]:
            d_density = joseph_bwd_vol(rows, g, ctx.shape, axis, h, n_steps, arg)
        return d_density, d_rows, None, None, None, None, None, None


class JosephMarchChannels(torch.autograd.Function):
    """``image (C, R) = joseph_channels(density, rows; labels)``.

    Forward: ``joseph_fwd_ch``. Backward: the rays' cotangent from
    ``joseph_bwd_rays_ch`` (zero for amin/amax), the density's from
    ``joseph_bwd_vol_ch``, each only when asked for. The labels get none.
    ``joseph_fwd_ch`` and ``joseph_bwd_rays_ch`` read the bricked copies of
    the density and the labelmap (``brick.bricked``), so a render and its
    pose backward, and every render of one CT, make each once.
    """

    @staticmethod
    def forward(ctx, density, rows, labels, axis, h, n_steps, n_channels, storage=None):
        ctx.march = (axis, h, n_steps)
        ctx.shape, ctx.storage = tuple(density.shape), storage
        out = joseph_fwd_ch(rows, density, labels, axis, h, n_steps, n_channels, storage)
        ctx.save_for_backward(rows, labels, density if ctx.needs_input_grad[1] else None)
        return out

    @staticmethod
    def backward(ctx, g):
        rows, labels, density = ctx.saved_tensors
        axis, h, n_steps = ctx.march
        d_density = d_rows = None
        if ctx.needs_input_grad[1]:
            d7 = joseph_bwd_rays_ch(rows, density, labels, axis, h, n_steps, g, ctx.storage)
            d_rows = torch.cat([d7, d7.new_zeros((NROWS - GRAD_ROWS, d7.shape[1]))])
        if ctx.needs_input_grad[0]:
            d_density = joseph_bwd_vol_ch(rows, g, labels, ctx.shape, axis, h, n_steps)
        return d_density, d_rows, None, None, None, None, None, None


def joseph_march_raycast(density: torch.Tensor, source: torch.Tensor, target: torch.Tensor,
                         weights: torch.Tensor, *, axis: int, step: float = 1.0,
                         n_steps: Optional[int] = None, voxel_shift: float = 0.5,
                         eps: float = 1e-8, reduce: str = "sum", fused: bool = True,
                         mask: Optional[torch.Tensor] = None,
                         n_channels: Optional[int] = None, storage=None) -> torch.Tensor:
    """Joseph ``(B, 1, N)`` by plane march along ``axis`` (voxel space).

    ``step`` is the stride ``h`` in planes (fractional: the trilinear march)
    and ``n_steps`` the number of samples (default: cover the axis).
    ``reduce="max"`` renders the MIP; ``fused=False`` takes the pose
    gradient from the two-pass ``joseph_bwd_rays``. With a labelmap
    ``mask`` (of the density's shape) the render is ``(B, n_channels, N)``
    per-structure channels, a sum whatever ``reduce`` and ``fused`` say.
    ``storage="bf16"`` reads the density rounded to bf16 (the kernels' bf16
    instantiations on a bf16 bricked copy); its gradient stays float32.
    """
    B, N, _ = target.shape
    h = float(step)
    if n_steps is None:
        n_steps = int(-(-density.shape[axis] // h))
    rows = prep_rays(source, target, weights, axis, density.shape, voxel_shift, eps,
                     quadrature="joseph", h=h)
    if mask is not None:
        if n_channels is None:
            raise ValueError("n_channels must be provided when rendering with a mask")
        out = JosephMarchChannels.apply(density, rows, as_labels(mask), axis, h, int(n_steps),
                                        int(n_channels), storage)
        return out.reshape(-1, B, N).permute(1, 0, 2)
    return JosephMarch.apply(density, rows, axis, h, int(n_steps), reduce, fused,
                             storage).reshape(B, 1, N)
