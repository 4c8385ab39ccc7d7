"""Exact Siddon slab-march kernels: wrappers, plain versions, autograd.

Counterpart of ``diffdrr_tpu/ops/pallas/siddon.py``. Five functions of the
packed rays (``prep.py``) and the density:

  * ``siddon_fwd(rows, density, axis) -> (R,)``: the line integrals, the
    sum-mode function of the TPU's ``_fwd_kernel`` and
    ``_fwd_plane_major_kernel``;
  * ``siddon_fwdgrad(rows, density, axis) -> (10, R)``: the 9 gradient rows
    d(value)/d(row) in row order, then the value, the function of
    ``_fwdgrad_kernel``;
  * ``siddon_fwd_max(rows, density, axis) -> ((R,), (R,) int32)``: the MIP
    value (the largest segment contribution) and its argmax, coded slab * 4
    + segment and -1 for none, the max mode of ``_fwd_kernel``;
  * ``siddon_bwd_rays(rows, density, axis, g, arg=None) -> (9, R)``:
    g * d(value)/d(row), gated to the argmax in MIP, the function of
    ``_bwd_rays_kernel``;
  * ``siddon_bwd_vol(rows, g, shape, axis, arg=None) -> shape``: the density
    gradient, the function of ``_bwd_vol_kernel``.

Each wrapper launches its CUDA kernel (``csrc/siddon.cu``) on a CUDA tensor
and counts the launch in its ``launches`` attribute; on a CPU tensor it runs
the plain PyTorch version beside it, which repeats the kernel's arithmetic
slab by slab for all rays at once. Any other device raises; so does a build
or launch failure. There is no fallback from the kernel to the plain version.

``SiddonSlab`` is the autograd boundary, in sum or max mode. It computes
each gradient only when autograd asks for it: a pose-only backward never
launches ``siddon_bwd_vol``, a density-only one never ``siddon_fwdgrad``.
"""

from __future__ import annotations

import torch

from ._launch import (call, check, check_cotangent, check_rows, ptr, runs_plain,
                      strides_extents)
from .brick import bricked
from .prep import NROWS, ROW_NAMES, march_perm, prep_rays

__all__ = [
    "siddon_fwd", "siddon_fwdgrad", "siddon_fwd_max", "siddon_bwd_rays", "siddon_bwd_vol",
    "siddon_fwd_plain", "siddon_fwdgrad_plain", "siddon_fwd_max_plain",
    "siddon_bwd_rays_plain", "siddon_bwd_vol_plain",
    "SiddonSlab", "siddon_slab_raycast", "reset_launch_counts",
]

FUSED_ROWS = NROWS + 1


# -----------------------------------------------------------------------------
# Plain PyTorch versions (all rays at once, one slab at a time)
# -----------------------------------------------------------------------------


def _safe_d(d):
    return torch.where(torch.abs(d) < 1e-20, torch.full_like(d, 1e-20), d)


def _crossing(g, d, alo, ahi):
    m_lo = torch.round(g + alo * d)
    m_hi = torch.round(g + ahi * d)
    base = torch.minimum(m_lo, m_hi)
    bound = torch.maximum(m_lo, m_hi) - 0.5
    ac = (bound - g) / _safe_d(d)
    t = torch.where(m_lo != m_hi, torch.minimum(torch.maximum(ac, alo), ahi), alo)
    return base, t


def _slab(r, s):
    """Segments of slab ``s`` for every ray (``_slab_segments`` on the TPU)."""
    sf = float(s)
    a1 = (sf - 0.5) * r["a"] + r["b"]
    a2 = (sf + 0.5) * r["a"] + r["b"]
    alo = torch.maximum(torch.minimum(a1, a2), r["amin"])
    ahi_raw = torch.minimum(torch.maximum(a1, a2), r["amax"])
    ahi = torch.maximum(ahi_raw, alo)
    y0, ty = _crossing(r["gy"], r["dy"], alo, ahi)
    z0, tz = _crossing(r["gz"], r["dz"], alo, ahi)
    t1 = torch.minimum(ty, tz)
    t2 = torch.maximum(ty, tz)
    lens = [t1 - alo, t2 - t1, ahi - t2]
    mids = [(alo + t1) * 0.5, (t1 + t2) * 0.5, (t2 + ahi) * 0.5]
    sel = [(torch.clamp(torch.round(r["gy"] + m * r["dy"]) - y0, 0.0, 1.0),
            torch.clamp(torch.round(r["gz"] + m * r["dz"]) - z0, 0.0, 1.0))
           for m in mids]
    return dict(alo=alo, ahi=ahi, ahi_raw=ahi_raw, a1=a1, a2=a2, ty=ty, tz=tz,
                y0=y0, z0=z0, lens=lens, sel=sel)


def _plane_values(plane, fy, fz):
    """plane[fy, fz] at integer-valued float positions; 0 outside the plane."""
    Y, Z = plane.shape
    valid = (fy >= 0) & (fy < Y) & (fz >= 0) & (fz < Z)
    iy = torch.clamp(fy, 0, Y - 1).to(torch.int64)
    iz = torch.clamp(fz, 0, Z - 1).to(torch.int64)
    return torch.where(valid, plane[iy, iz], torch.zeros_like(fy))


def _segment_values(vol_p, s, sl):
    plane = vol_p[s]
    return [_plane_values(plane, sl["y0"] + iy, sl["z0"] + iz) for iy, iz in sl["sel"]]


def _rows_dict(rows):
    return dict(zip(ROW_NAMES, rows.unbind(0)))


@torch.no_grad()
def siddon_fwd_plain(rows: torch.Tensor, density: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain version of :func:`siddon_fwd`."""
    r = _rows_dict(rows)
    vol_p = density.permute(march_perm(axis))
    acc = torch.zeros_like(r["a"])
    for s in range(vol_p.shape[0]):
        sl = _slab(r, s)
        V = _segment_values(vol_p, s, sl)
        seg = V[0] * sl["lens"][0] + V[1] * sl["lens"][1] + V[2] * sl["lens"][2]
        acc = acc + r["sc"] * seg
    return acc


def _slab_rows(r, sl, s, V1, V2, V3):
    """Slab ``s``'s 9 terms d(value)/d(row) for segment values V1..V3, and
    sum_j V_j len_j (``slab_rows`` in ``csrc/siddon.cuh``)."""
    w = r["sc"]
    d_t1 = w * (V1 - V2)
    d_t2 = w * (V2 - V3)
    d_alo = -w * V1
    d_ahi = w * V3

    ty, tz = sl["ty"], sl["tz"]
    ty_is_min = (ty <= tz).float()
    d_ty = d_t1 * ty_is_min + d_t2 * (1 - ty_is_min)
    d_tz = d_t1 * (1 - ty_is_min) + d_t2 * ty_is_min
    alo, ahi = sl["alo"], sl["ahi"]

    def route(t, d_t, d_pos):
        interior = ((t > alo) & (t < ahi)).float()
        at_hi = (t >= ahi).float()
        at_lo = 1.0 - interior - at_hi
        sd = _safe_d(d_pos)
        return (d_t * interior * (-1.0 / sd), d_t * interior * (-t / sd),
                d_t * at_lo, d_t * at_hi)

    d_gy, d_dy, d_alo_y, d_ahi_y = route(ty, d_ty, r["dy"])
    d_gz, d_dz, d_alo_z, d_ahi_z = route(tz, d_tz, r["dz"])
    d_alo_tot = d_alo + d_alo_y + d_alo_z
    d_ahi_tot = d_ahi + d_ahi_y + d_ahi_z

    empty = (sl["ahi_raw"] < alo).float()
    d_alo_eff = d_alo_tot + empty * d_ahi_tot
    d_ahi_eff = (1.0 - empty) * d_ahi_tot
    lo_is_a1 = (sl["a1"] <= sl["a2"]).float()
    lo_interior = (alo > r["amin"]).float()
    hi_interior = (sl["ahi_raw"] < r["amax"]).float()
    d_a1 = (d_alo_eff * lo_is_a1 * lo_interior
            + d_ahi_eff * (1 - lo_is_a1) * hi_interior)
    d_a2 = (d_alo_eff * (1 - lo_is_a1) * lo_interior
            + d_ahi_eff * lo_is_a1 * hi_interior)

    sf = float(s)
    lens = sl["lens"]
    seg = V1 * lens[0] + V2 * lens[1] + V3 * lens[2]
    terms = (d_a1 * (sf - 0.5) + d_a2 * (sf + 0.5), d_a1 + d_a2,
             d_gy, d_dy, d_gz, d_dz, seg,
             d_alo_eff * (1.0 - lo_interior), d_ahi_eff * (1.0 - hi_interior))
    return terms, seg


def _gate(V, arg, s):
    """MIP: each segment value kept only where the argmax is its code."""
    return [torch.where(arg == s * 4 + j, v, torch.zeros_like(v)) for j, v in enumerate(V)]


@torch.no_grad()
def siddon_fwdgrad_plain(rows: torch.Tensor, density: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain version of :func:`siddon_fwdgrad`: (10, R) rows, then the value."""
    r = _rows_dict(rows)
    vol_p = density.permute(march_perm(axis))
    acc = [torch.zeros_like(r["a"]) for _ in range(FUSED_ROWS)]
    for s in range(vol_p.shape[0]):
        sl = _slab(r, s)
        terms, seg = _slab_rows(r, sl, s, *_segment_values(vol_p, s, sl))
        acc = [a + t for a, t in zip(acc, terms + (r["sc"] * seg,))]
    return torch.stack(acc)


@torch.no_grad()
def siddon_fwd_max_plain(rows: torch.Tensor, density: torch.Tensor, axis: int):
    """Plain version of :func:`siddon_fwd_max`: (value, int32 argmax)."""
    r = _rows_dict(rows)
    vol_p = density.permute(march_perm(axis))
    best = torch.zeros_like(r["a"])
    arg = torch.full(best.shape, -1, dtype=torch.int32, device=best.device)
    for s in range(vol_p.shape[0]):
        sl = _slab(r, s)
        for j, (V, length) in enumerate(zip(_segment_values(vol_p, s, sl), sl["lens"])):
            x = length * r["sc"] * V
            better = x > best
            arg = torch.where(better, torch.full_like(arg, s * 4 + j), arg)
            best = torch.where(better, x, best)
    return best, arg


@torch.no_grad()
def siddon_bwd_rays_plain(rows: torch.Tensor, density: torch.Tensor, axis: int,
                          g: torch.Tensor, arg=None) -> torch.Tensor:
    """Plain version of :func:`siddon_bwd_rays`: (9, R)."""
    r = _rows_dict(rows)
    vol_p = density.permute(march_perm(axis))
    acc = [torch.zeros_like(r["a"]) for _ in range(NROWS)]
    for s in range(vol_p.shape[0]):
        sl = _slab(r, s)
        V = _segment_values(vol_p, s, sl)
        if arg is not None:
            V = _gate(V, arg, s)
        terms, _ = _slab_rows(r, sl, s, *V)
        acc = [a + t for a, t in zip(acc, terms)]
    return torch.stack(acc) * g


@torch.no_grad()
def siddon_bwd_vol_plain(rows: torch.Tensor, g: torch.Tensor, shape, axis: int,
                         arg=None) -> torch.Tensor:
    """Plain version of :func:`siddon_bwd_vol`: a float32 volume of ``shape``."""
    r = _rows_dict(rows)
    grad = torch.zeros(tuple(shape), dtype=torch.float32, device=rows.device)
    grad_p = grad.permute(march_perm(axis))  # a view: writes land in ``grad``
    X, Y, Z = grad_p.shape
    for s in range(X):
        sl = _slab(r, s)
        for j, ((iy, iz), length) in enumerate(zip(sl["sel"], sl["lens"])):
            fy, fz = sl["y0"] + iy, sl["z0"] + iz
            ok = (length > 0) & (fy >= 0) & (fy < Y) & (fz >= 0) & (fz < Z)
            if arg is not None:
                ok = ok & (arg == s * 4 + j)
            x = torch.where(ok, length * r["sc"] * g, torch.zeros_like(g))
            iy_ = torch.clamp(fy, 0, Y - 1).to(torch.int64)
            iz_ = torch.clamp(fz, 0, Z - 1).to(torch.int64)
            grad_p[s].index_put_((iy_, iz_), x, accumulate=True)
    return grad


# -----------------------------------------------------------------------------
# Wrappers: the CUDA kernel on a CUDA tensor, the plain version on the CPU
# -----------------------------------------------------------------------------


def _launch(fn_name: str, rows: torch.Tensor, density: torch.Tensor, axis: int,
            *args) -> None:
    """``fn_name(rows, R, density, strides, extents, *args, stream)``."""
    rows = rows.contiguous()
    call("siddon", fn_name, rows.device, rows.data_ptr(), rows.shape[1], density.data_ptr(),
         *strides_extents(density, axis), *args)


def siddon_fwd(rows: torch.Tensor, density: torch.Tensor, axis: int) -> torch.Tensor:
    """Line integrals ``(R,)`` of the rays ``rows (9, R)`` through ``density``.
    The kernel reads the density's bricked copy (``brick.bricked``: made
    once for an unchanged density)."""
    check("siddon", rows, density, axis)
    if runs_plain("siddon_fwd", rows):
        return siddon_fwd_plain(rows, density, axis)
    vol = bricked(density)
    rows = rows.contiguous()
    out = torch.empty(rows.shape[1], dtype=torch.float32, device=rows.device)
    call("siddon", "siddon_fwd", rows.device, rows.data_ptr(), rows.shape[1],
         vol.data.data_ptr(), *vol.args(axis), out.data_ptr())
    siddon_fwd.launches += 1
    return out


def siddon_fwdgrad(rows: torch.Tensor, density: torch.Tensor, axis: int) -> torch.Tensor:
    """``(10, R)``: d(value)/d(row) for the 9 rows, then the value. The
    kernel reads the density's bricked copy, as ``siddon_fwd`` does, with
    several lanes a ray; its rows are the same on every run."""
    check("siddon", rows, density, axis)
    if runs_plain("siddon_fwdgrad", rows):
        return siddon_fwdgrad_plain(rows, density, axis)
    vol = bricked(density)
    rows = rows.contiguous()
    out = torch.empty((FUSED_ROWS, rows.shape[1]), dtype=torch.float32, device=rows.device)
    call("siddon", "siddon_fwdgrad", rows.device, rows.data_ptr(), rows.shape[1],
         vol.data.data_ptr(), *vol.args(axis), out.data_ptr())
    siddon_fwdgrad.launches += 1
    return out


def siddon_fwd_max(rows: torch.Tensor, density: torch.Tensor, axis: int):
    """MIP ``(value (R,), argmax (R,) int32)``: the largest len * w * V over
    each ray's segments and its code slab * 4 + segment (-1: none beat 0)."""
    check("siddon", rows, density, axis)
    if runs_plain("siddon_fwd_max", rows):
        return siddon_fwd_max_plain(rows, density, axis)
    val = torch.empty(rows.shape[1], dtype=torch.float32, device=rows.device)
    arg = torch.empty(rows.shape[1], dtype=torch.int32, device=rows.device)
    _launch("siddon_fwd_max", rows, density, axis, val.data_ptr(), arg.data_ptr())
    siddon_fwd_max.launches += 1
    return val, arg


def siddon_bwd_rays(rows: torch.Tensor, density: torch.Tensor, axis: int,
                    g: torch.Tensor, arg=None) -> torch.Tensor:
    """``(9, R)``: g * d(value)/d(row); MIP when the argmax ``arg`` is given."""
    check("siddon", rows, density, axis)
    g = check_cotangent(rows, g, arg)
    if runs_plain("siddon_bwd_rays", rows):
        return siddon_bwd_rays_plain(rows, density, axis, g, arg)
    out = torch.empty((NROWS, rows.shape[1]), dtype=torch.float32, device=rows.device)
    _launch("siddon_bwd_rays", rows, density, axis, g.data_ptr(), ptr(arg), out.data_ptr())
    siddon_bwd_rays.launches += 1
    return out


def siddon_bwd_vol(rows: torch.Tensor, g: torch.Tensor, shape, axis: int,
                   arg=None) -> torch.Tensor:
    """d(loss)/d(density): a contiguous float32 volume of the density's
    ``shape``; MIP when the argmax ``arg`` is given. The kernel adds with
    float atomics, so its last bits vary from run to run."""
    check_rows("siddon", rows, axis)
    g = check_cotangent(rows, g, arg)
    if len(shape) != 3:
        raise ValueError(f"shape must be (X, Y, Z), got {tuple(shape)}")
    if runs_plain("siddon_bwd_vol", rows):
        return siddon_bwd_vol_plain(rows, g, shape, axis, arg)
    rows = rows.contiguous()
    grad = torch.zeros(tuple(shape), dtype=torch.float32, device=rows.device)
    call("siddon", "siddon_bwd_vol", rows.device, rows.data_ptr(), rows.shape[1], g.data_ptr(),
         ptr(arg), grad.data_ptr(), *strides_extents(grad, axis))
    siddon_bwd_vol.launches += 1
    return grad


KERNELS = (siddon_fwd, siddon_fwdgrad, siddon_fwd_max, siddon_bwd_rays, siddon_bwd_vol)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


reset_launch_counts()


# -----------------------------------------------------------------------------
# Autograd
# -----------------------------------------------------------------------------


class SiddonSlab(torch.autograd.Function):
    """``value (R,) = siddon(density, rows)``, by sum or by max (MIP).

    Forward: in sum mode ``siddon_fwdgrad`` when the rays need a gradient and
    ``fused`` (their backward is then ``rows * g``), else ``siddon_fwd``; in
    max mode ``siddon_fwd_max``, whose argmax gates the backward. Backward:
    the rays' cotangent from the fused rows or ``siddon_bwd_rays``, the
    density's from ``siddon_bwd_vol``, each only when asked for.
    """

    @staticmethod
    def forward(ctx, density, rows, axis, reduce="sum", fused=True):
        if reduce not in ("sum", "max"):
            raise ValueError(f"reduce must be 'sum' or 'max', not {reduce!r}")
        ray_grad = ctx.needs_input_grad[1]
        ctx.axis, ctx.shape = axis, tuple(density.shape)
        ctx.fused = reduce == "sum" and fused and ray_grad
        arg = grad_rows = None
        if reduce == "max":
            out, arg = siddon_fwd_max(rows, density, axis)
        elif ctx.fused:
            allrows = siddon_fwdgrad(rows, density, axis)
            out, grad_rows = allrows[NROWS], allrows[:NROWS]
        else:
            out = siddon_fwd(rows, density, axis)
        # siddon_bwd_rays re-reads the density; the other backwards need only rows.
        ctx.save_for_backward(rows, density if ray_grad and not ctx.fused else None,
                              arg, grad_rows)
        return out

    @staticmethod
    def backward(ctx, g):
        rows, density, arg, grad_rows = ctx.saved_tensors
        d_density = d_rows = None
        if ctx.needs_input_grad[1]:
            d_rows = (grad_rows * g if ctx.fused
                      else siddon_bwd_rays(rows, density, ctx.axis, g, arg))
        if ctx.needs_input_grad[0]:
            d_density = siddon_bwd_vol(rows, g, ctx.shape, ctx.axis, arg)
        return d_density, d_rows, None, None, None


def siddon_slab_raycast(density: torch.Tensor, source: torch.Tensor,
                        target: torch.Tensor, weights: torch.Tensor, *, axis: int,
                        voxel_shift: float = 0.5, eps: float = 1e-8,
                        reduce: str = "sum", fused: bool = True) -> torch.Tensor:
    """Exact Siddon ``(B, 1, N)`` by slab march along ``axis`` (voxel space).

    ``reduce="max"`` renders the MIP. ``fused=False`` takes the pose
    gradient from the two-pass ``siddon_bwd_rays`` instead of the fused
    forward. Exact for rays whose transverse slopes along ``axis`` are at
    most 1; ``DRR.render`` checks that and sends other poses to the sort
    oracle.
    """
    B, N, _ = target.shape
    rows = prep_rays(source, target, weights, axis, density.shape, voxel_shift, eps)
    return SiddonSlab.apply(density, rows, axis, reduce, fused).reshape(B, 1, N)
