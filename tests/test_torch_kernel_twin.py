"""The CUDA kernels' own arithmetic, compiled for the host and checked here.

``csrc/siddon.cuh`` and ``csrc/joseph.cuh`` hold all per-ray arithmetic of
the kernels in ``__host__ __device__`` functions; without nvcc the macros
are empty, so g++ compiles the very same code. A tiny test-only C++ loop
walks over the rays where a kernel would launch one thread per ray; for the
two density-gradient scatters, which launch one warp per ray, a second loop
also walks each ray's slabs (steps) in the warp's order: passes of 32 (lane
l takes lo + l, lo + l + 32, ...), each pass's adds laid out in path order
and made last to first. Its
results are held against the plain PyTorch versions, which walk every slab
(every march step) of the volume for all rays at once, so the comparison
also checks the kernels' per-ray slab and step ranges (the partially
entered slab, the first and last in-slab steps).

Tolerance: both sides do the same float32 operations in the same order
(rintf and torch.round both round half to even, FMA contraction is off), so
they agree to the last bit except for the sign of zero terms; the asserts
allow 1e-6 relative to the largest value to stay robust to that. The MIP
argmax must match exactly. The density gradient gets 1e-5: the twin adds
ray by ray (where the kernel adds with atomics), the plain version slab by
slab, so the summation order differs.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from diffdrr_tpu_torch.ops.kernels import brick, build
from diffdrr_tpu_torch.ops.kernels.brick import (brick_density, brick_density_plain, bricked,
                                               clear_cache)
from diffdrr_tpu_torch.ops.kernels.prep import march_perm, prep_rays
from diffdrr_tpu_torch.ops.kernels import joseph as J
from diffdrr_tpu_torch.ops.kernels import siddon as K
from diffdrr_tpu_torch.ops.kernels.siddon import (
    siddon_bwd_rays_plain, siddon_bwd_vol_plain, siddon_fwd_max_plain, siddon_fwd_plain,
    siddon_fwdgrad_plain)

_TWIN_SRC = r"""
#include "siddon.cuh"
extern "C" void twin_fwd(const float* rows, int64_t R, const float* vol, int64_t ss,
                         int64_t sy, int64_t sz, int X, int Y, int Z, float* out) {
  siddon::Volume v{vol, ss, sy, sz, X, Y, Z};
  for (int64_t r = 0; r < R; ++r) out[r] = siddon::trace_fwd(siddon::load_ray(rows, R, r), v);
}
extern "C" void twin_fwdgrad(const float* rows, int64_t R, const float* vol, int64_t ss,
                             int64_t sy, int64_t sz, int X, int Y, int Z, float* out) {
  siddon::Volume v{vol, ss, sy, sz, X, Y, Z};
  float acc[siddon::kFusedRows];
  for (int64_t r = 0; r < R; ++r) {
    siddon::trace_fwdgrad(siddon::load_ray(rows, R, r), v, acc);
    for (int k = 0; k < siddon::kFusedRows; ++k) out[k * R + r] = acc[k];
  }
}
extern "C" void twin_fwd_max(const float* rows, int64_t R, const float* vol, int64_t ss,
                             int64_t sy, int64_t sz, int X, int Y, int Z, float* out,
                             int* arg) {
  siddon::Volume v{vol, ss, sy, sz, X, Y, Z};
  for (int64_t r = 0; r < R; ++r)
    siddon::trace_fwd_max(siddon::load_ray(rows, R, r), v, out + r, arg + r);
}
extern "C" void twin_bwd_rays(const float* rows, int64_t R, const float* vol, int64_t ss,
                              int64_t sy, int64_t sz, int X, int Y, int Z, const float* g,
                              const int* arg, float* out) {
  siddon::Volume v{vol, ss, sy, sz, X, Y, Z};
  float acc[siddon::kRows];
  for (int64_t r = 0; r < R; ++r) {
    siddon::trace_bwd_rays(siddon::load_ray(rows, R, r), v, g[r], arg ? arg[r] : -1,
                           arg != nullptr, acc);
    for (int k = 0; k < siddon::kRows; ++k) out[k * R + r] = acc[k];
  }
}
extern "C" void twin_bwd_vol(const float* rows, int64_t R, const float* g, const int* arg,
                             float* grad, int64_t gs, int64_t gy, int64_t gz, int X, int Y,
                             int Z) {
  siddon::GradVolume gv{grad, gs, gy, gz, X, Y, Z};
  for (int64_t r = 0; r < R; ++r)
    siddon::trace_bwd_vol(siddon::load_ray(rows, R, r), gv, g[r], arg ? arg[r] : -1,
                          arg != nullptr);
}
// The warp kernel's order: pass after pass of 32 slabs (lane l takes lo + l,
// lo + l + 32, ...), each pass's adds laid out in path order (slab, then
// segment) and made last to first, so not in the serial order.
extern "C" void twin_bwd_vol_warp(const float* rows, int64_t R, const float* g, const int* arg,
                                  float* grad, int64_t gs, int64_t gy, int64_t gz, int X,
                                  int Y, int Z) {
  siddon::GradVolume gv{grad, gs, gy, gz, X, Y, Z};
  for (int64_t r = 0; r < R; ++r) {
    siddon::Ray ray = siddon::load_ray(rows, R, r);
    int a = arg ? arg[r] : -1;
    int lo, hi;
    siddon::scatter_range(ray, X, a, arg != nullptr, &lo, &hi);
    for (int base = lo; base < hi; base += 32) {
      int64_t s_off[siddon::kSlabAdds * 32];
      float s_x[siddon::kSlabAdds * 32];
      int total = 0;
      for (int lane = 0; lane < 32 && base + lane < hi; ++lane) {
        int64_t off[siddon::kSlabAdds];
        float x[siddon::kSlabAdds];
        unsigned mask =
            siddon::slab_adds(ray, gv, base + lane, g[r], a, arg != nullptr, off, x);
        for (int j = 0; j < siddon::kSlabAdds; ++j)
          if (mask >> j & 1u) { s_off[total] = off[j]; s_x[total] = x[j]; ++total; }
      }
      for (int q = total - 1; q >= 0; --q) grad[s_off[q]] += s_x[q];
    }
  }
}
"""


def _build_twin(tmp_path_factory, name, source, defines=()):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available to build the host twin")
    d = tmp_path_factory.mktemp(name)
    src = d / f"{name}.cpp"
    src.write_text(source)
    lib = d / f"lib{name}.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    *(f"-D{d}" for d in defines), f"-I{build.CSRC}", "-o", str(lib), str(src)],
                   check=True, timeout=60)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    so = _build_twin(tmp_path_factory, "twin", _TWIN_SRC)
    vol_args = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    ptr = ctypes.c_void_p
    so.twin_fwd.argtypes = vol_args + [ptr]
    so.twin_fwdgrad.argtypes = vol_args + [ptr]
    so.twin_fwd_max.argtypes = vol_args + [ptr, ptr]
    so.twin_bwd_rays.argtypes = vol_args + [ptr, ptr, ptr]
    so.twin_bwd_vol.argtypes = [ptr, ctypes.c_int64, ptr, ptr, ptr, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int]
    so.twin_bwd_vol_warp.argtypes = so.twin_bwd_vol.argtypes
    for fn in (so.twin_fwd, so.twin_fwdgrad, so.twin_fwd_max, so.twin_bwd_rays,
               so.twin_bwd_vol, so.twin_bwd_vol_warp):
        fn.restype = None
    return so


def _geom(t, axis):
    """Strides, then extents, of ``t``'s march-permuted axes."""
    perm = march_perm(axis)
    return [t.stride(p) for p in perm] + [t.shape[p] for p in perm]


def _run_twin(so, fused, rows, vol, axis):
    rows = rows.contiguous()
    R = rows.shape[1]
    out = torch.empty((10, R) if fused else (R,), dtype=torch.float32)
    fn = so.twin_fwdgrad if fused else so.twin_fwd
    fn(rows.data_ptr(), R, vol.data_ptr(), *_geom(vol, axis), out.data_ptr())
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run_twin_fwd_max(so, rows, vol, axis):
    R = rows.shape[1]
    val = torch.empty(R, dtype=torch.float32)
    arg = torch.empty(R, dtype=torch.int32)
    so.twin_fwd_max(rows.data_ptr(), R, vol.data_ptr(), *_geom(vol, axis), val.data_ptr(),
                    arg.data_ptr())
    return val, arg


def _run_twin_bwd_rays(so, rows, vol, axis, g, arg):
    R = rows.shape[1]
    out = torch.empty((9, R), dtype=torch.float32)
    so.twin_bwd_rays(rows.data_ptr(), R, vol.data_ptr(), *_geom(vol, axis), g.data_ptr(),
                     _ptr(arg), out.data_ptr())
    return out


def _run_twin_bwd_vol(so, rows, g, shape, axis, arg):
    grad = torch.zeros(shape, dtype=torch.float32)
    so.twin_bwd_vol(rows.data_ptr(), rows.shape[1], g.data_ptr(), _ptr(arg), grad.data_ptr(),
                    *_geom(grad, axis))
    return grad


def _assert_rows_close(got, ref, rel=1e-6):
    for k in range(ref.shape[0]):
        np.testing.assert_allclose(got[k], ref[k], atol=rel * ref[k].abs().max().item() + 1e-30)


def _random_rays(rng, dims, axis, n):
    """Off-grid rays through a box, transverse slopes below 1 along ``axis``."""
    other = [a for a in range(3) if a != axis]
    src = np.zeros((n, 3))
    tgt = np.zeros((n, 3))
    src[:, axis] = -30.0 - 5 * rng.random(n)
    tgt[:, axis] = dims[axis] + 30.0 + 5 * rng.random(n)
    for a in other:
        c = rng.uniform(-2.0, dims[a] + 2.0, n)
        slope = rng.uniform(-0.9, 0.9, n)
        src[:, a] = c + slope * (src[:, axis] - dims[axis] / 2)
        tgt[:, a] = c + slope * (tgt[:, axis] - dims[axis] / 2)
    w = rng.uniform(0.5, 2.0, (n, 1, 1))
    as_t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    # One ray per batch element: source (n, 1, 3), target (n, 1, 3).
    return as_t(src[:, None]), as_t(tgt[:, None]), as_t(w)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_matches_plain_random_rays(twin, axis):
    rng = np.random.default_rng(10 + axis)
    dims = (20, 24, 16)
    vol = torch.tensor(rng.uniform(0.1, 1.0, dims), dtype=torch.float32)
    src, tgt, w = _random_rays(rng, dims, axis, 200)
    rows = prep_rays(src, tgt, w, axis, dims)
    ref = siddon_fwd_plain(rows, vol, axis)
    got = _run_twin(twin, False, rows, vol, axis)
    np.testing.assert_allclose(got, ref, atol=1e-6 * ref.abs().max().item())
    ref_g = siddon_fwdgrad_plain(rows, vol, axis)
    got_g = _run_twin(twin, True, rows, vol, axis)
    for k in range(10):
        np.testing.assert_allclose(got_g[k], ref_g[k],
                                   atol=1e-6 * ref_g[k].abs().max().item() + 1e-30)


@pytest.mark.parametrize("mode", ["sum", "mip"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_backward_matches_plain_random_rays(twin, axis, mode):
    """trace_fwd_max, trace_bwd_rays and trace_bwd_vol against the plain
    versions, at the random rays above and a random cotangent g."""
    rng = np.random.default_rng(20 + axis)
    dims = (20, 24, 16)
    vol = torch.tensor(rng.uniform(0.1, 1.0, dims), dtype=torch.float32)
    src, tgt, w = _random_rays(rng, dims, axis, 200)
    rows = prep_rays(src, tgt, w, axis, dims)
    g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32)
    val, arg = siddon_fwd_max_plain(rows, vol, axis)
    got_val, got_arg = _run_twin_fwd_max(twin, rows, vol, axis)
    assert torch.equal(got_arg, arg)
    np.testing.assert_allclose(got_val, val, atol=1e-6 * val.abs().max().item())
    assert (arg >= 0).sum() > 150  # most rays cross the volume
    arg = arg if mode == "mip" else None
    _assert_rows_close(_run_twin_bwd_rays(twin, rows, vol, axis, g, arg),
                       siddon_bwd_rays_plain(rows, vol, axis, g, arg))
    ref = siddon_bwd_vol_plain(rows, g, dims, axis, arg)
    got = _run_twin_bwd_vol(twin, rows, g, dims, axis, arg)
    assert torch.count_nonzero(ref) > 0
    np.testing.assert_allclose(got, ref, atol=1e-5 * ref.abs().max().item())


def test_twin_bwd_vol_writes_the_density_layout(twin):
    """The scatter goes through the gradient's own strides: a gradient
    volume of another memory order gets the same values."""
    rng = np.random.default_rng(30)
    dims = (20, 24, 16)
    src, tgt, w = _random_rays(rng, dims, 1, 100)
    rows = prep_rays(src, tgt, w, 1, dims)
    g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32)
    ref = _run_twin_bwd_vol(twin, rows, g, dims, 1, None)
    grad_t = torch.zeros(dims[::-1], dtype=torch.float32).permute(2, 1, 0)  # Fortran order
    twin.twin_bwd_vol(rows.data_ptr(), rows.shape[1], g.data_ptr(), None, grad_t.data_ptr(),
                      *_geom(grad_t, 1))
    np.testing.assert_allclose(grad_t, ref, atol=1e-6 * ref.abs().max().item())


def test_twin_partial_entry_slab(twin):
    """Rays entering mid-slab through a transverse face keep their partial
    first segment (the per-ray slab range must not drop it)."""
    vol = torch.ones((32, 32, 32))
    n = 64
    x_e = 10.3
    y_s = -0.5 - 0.8 * (x_e + 50)
    jit = np.linspace(0, 0.02, n)
    src = torch.tensor(np.stack([np.full(n, -50.0), np.full(n, y_s), np.full(n, 16.0)], 1),
                       dtype=torch.float32)[:, None]
    tgt = torch.tensor(np.stack([np.full(n, 50.0), np.full(n, y_s + 80.0), 16.0 + jit], 1),
                       dtype=torch.float32)[:, None]
    w = torch.ones((n, 1, 1))
    rows = prep_rays(src, tgt, w, 0, vol.shape)
    ref = siddon_fwdgrad_plain(rows, vol, 0)
    got = _run_twin(twin, True, rows, vol, 0)
    for k in range(10):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6 * ref[k].abs().max().item() + 1e-30)


def test_twin_missed_rays_are_zero(twin):
    """Rays that miss the volume give exact zeros in every row."""
    vol = torch.ones((8, 8, 8))
    src = torch.tensor([[[-20.0, 50.0, 50.0]], [[-20.0, -30.0, 4.0]]])
    tgt = torch.tensor([[[30.0, 52.0, 51.0]], [[30.0, -31.0, 4.5]]])
    w = torch.ones((2, 1, 1))
    rows = prep_rays(src, tgt, w, 0, vol.shape)
    got = _run_twin(twin, True, rows, vol, 0)
    assert torch.count_nonzero(got) == 0


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """On a card: both CUDA kernels against their plain versions (run with
    ``python -m pytest --noconftest tests/test_torch_kernel_twin.py -m gpu``);
    siddon_fwdgrad also on every march axis (``_gpu_fused_cases``) and
    launched twice with the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    vol = torch.tensor(rng.uniform(0.1, 1.0, (48, 40, 32)), dtype=torch.float32, device="cuda")
    u, v = np.meshgrid(np.linspace(-3.3, 43.1, 32), np.linspace(-2.7, 35.9, 32), indexing="ij")
    tv = np.stack([u, v, np.full_like(u, 80.37)], -1).reshape(1, -1, 3)
    sv = np.array([[[20.3, 18.1, -50.2]]])
    w = np.linalg.norm(tv - sv, axis=-1)[:, None, :]
    rows = prep_rays(*(torch.tensor(x, dtype=torch.float32, device="cuda") for x in (sv, tv, w)),
                     2, vol.shape)
    ref = K.siddon_fwd_plain(rows, vol, 2)
    got = K.siddon_fwd(rows, vol, 2)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * ref.abs().max().item())
    ref_g = K.siddon_fwdgrad_plain(rows, vol, 2)
    got_g = K.siddon_fwdgrad(rows, vol, 2)
    for k in range(10):
        torch.testing.assert_close(got_g[k], ref_g[k], rtol=0,
                                   atol=1e-3 * ref_g[k].abs().max().item() + 1e-30)
    for label, axis, vol, rows in _gpu_fused_cases():
        got = K.siddon_fwdgrad(rows, vol, axis)
        again = K.siddon_fwdgrad(rows, vol, axis)
        ref = K.siddon_fwdgrad_plain(rows, vol, axis)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(again)), label
        _assert_fused_close(got.cpu(), ref.cpu(), 9, label)


def _gpu_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(6)
    vol = torch.tensor(rng.uniform(0.1, 1.0, (48, 40, 32)), dtype=torch.float32, device="cuda")
    u, v = np.meshgrid(np.linspace(-3.3, 43.1, 32), np.linspace(-2.7, 35.9, 32), indexing="ij")
    tv = np.stack([u, v, np.full_like(u, 80.37)], -1).reshape(1, -1, 3)
    sv = np.array([[[20.3, 18.1, -50.2]]])
    w = np.linalg.norm(tv - sv, axis=-1)[:, None, :]
    rows = prep_rays(*(torch.tensor(x, dtype=torch.float32, device="cuda") for x in (sv, tv, w)),
                     2, vol.shape)
    g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32, device="cuda")
    return vol, rows, g


@pytest.mark.gpu
def test_cuda_fwd_max_matches_plain_version():
    """On a card: siddon_fwd_max against its plain version (value and argmax)."""
    vol, rows, _ = _gpu_scene()
    val, arg = K.siddon_fwd_max(rows, vol, 2)
    ref_val, ref_arg = K.siddon_fwd_max_plain(rows, vol, 2)
    assert torch.equal(arg, ref_arg)
    torch.testing.assert_close(val, ref_val, rtol=0, atol=1e-4 * ref_val.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sum", "mip"])
def test_cuda_backward_kernels_match_plain_versions(mode):
    """On a card: siddon_bwd_rays (rows atol 1e-3 * max|row|) and
    siddon_bwd_vol (atol 1e-4 * max, float atomics) against their plain
    versions, in sum and MIP modes."""
    vol, rows, g = _gpu_scene()
    arg = K.siddon_fwd_max_plain(rows, vol, 2)[1] if mode == "mip" else None
    got = K.siddon_bwd_rays(rows, vol, 2, g, arg)
    ref = K.siddon_bwd_rays_plain(rows, vol, 2, g, arg)
    for k in range(9):
        torch.testing.assert_close(got[k], ref[k], rtol=0,
                                   atol=1e-3 * ref[k].abs().max().item() + 1e-30)
    got_v = K.siddon_bwd_vol(rows, g, vol.shape, 2, arg)
    ref_v = K.siddon_bwd_vol_plain(rows, g, vol.shape, 2, arg)
    torch.cuda.synchronize()
    assert got_v.is_contiguous() and got_v.shape == vol.shape
    torch.testing.assert_close(got_v, ref_v, rtol=0, atol=1e-4 * ref_v.abs().max().item())


# -----------------------------------------------------------------------------
# csrc/joseph.cuh: the Joseph and trilinear march
# -----------------------------------------------------------------------------

_JOSEPH_TWIN_SRC = r"""
#include "joseph.cuh"
using namespace joseph;
static March mk(float h, int n, int blend) {
  March m;
  m.h = h;
  m.n_steps = n;
  m.blend = blend != 0;
  return m;
}
#define VOL_ARGS const float* rows, int64_t R, const float* vol, int64_t ss, int64_t sy, \
                 int64_t sz, int X, int Y, int Z, float h, int n, int blend
#define SETUP Volume v{vol, ss, sy, sz, X, Y, Z}; March m = mk(h, n, blend)
extern "C" void jt_fwd(VOL_ARGS, float* out) {
  SETUP;
  for (int64_t r = 0; r < R; ++r) out[r] = trace_fwd(load_ray(rows, R, r), v, m);
}
extern "C" void jt_fwd_max(VOL_ARGS, float* out, int* arg) {
  SETUP;
  for (int64_t r = 0; r < R; ++r) trace_fwd_max(load_ray(rows, R, r), v, m, out + r, arg + r);
}
extern "C" void jt_fwdgrad(VOL_ARGS, float* out, int* arg) {
  SETUP;
  float acc[kFusedRows];
  for (int64_t r = 0; r < R; ++r) {
    trace_fwdgrad(load_ray(rows, R, r), v, m, arg != nullptr, acc, arg ? arg + r : nullptr);
    for (int i = 0; i < kFusedRows; ++i) out[i * R + r] = acc[i];
  }
}
extern "C" void jt_bwd_rays(VOL_ARGS, const float* g, const int* arg, float* out) {
  SETUP;
  float acc[kRows];
  for (int64_t r = 0; r < R; ++r) {
    trace_bwd_rays(load_ray(rows, R, r), v, m, g[r], arg ? arg[r] : -1, arg != nullptr, acc);
    for (int i = 0; i < kRows; ++i) out[i * R + r] = acc[i];
  }
}
extern "C" void jt_bwd_vol(const float* rows, int64_t R, const float* g, const int* arg,
                           float* grad, int64_t gs, int64_t gy, int64_t gz, int X, int Y,
                           int Z, float h, int n, int blend) {
  GradVolume gv{grad, gs, gy, gz, X, Y, Z};
  March m = mk(h, n, blend);
  for (int64_t r = 0; r < R; ++r)
    trace_bwd_vol(load_ray(rows, R, r), gv, m, g[r], arg ? arg[r] : -1, arg != nullptr);
}
// The warp kernel's order: pass after pass of 32 steps (lane l takes lo + l,
// lo + l + 32, ...), each pass's adds laid out in path order (step, then
// neighbour) and made last to first, so not in the serial order.
extern "C" void jt_bwd_vol_warp(const float* rows, int64_t R, const float* g, const int* arg,
                                float* grad, int64_t gs, int64_t gy, int64_t gz, int X, int Y,
                                int Z, float h, int n, int blend) {
  GradVolume gv{grad, gs, gy, gz, X, Y, Z};
  March m = mk(h, n, blend);
  for (int64_t r = 0; r < R; ++r) {
    Ray ray = load_ray(rows, R, r);
    int lo, hi;
    scatter_range(ray, m, arg ? arg[r] : -1, arg != nullptr, &lo, &hi);
    for (int base = lo; base < hi; base += 32) {
      int64_t s_off[kStepAdds * 32];
      float s_x[kStepAdds * 32];
      int total = 0;
      for (int lane = 0; lane < 32 && base + lane < hi; ++lane) {
        int64_t off[kStepAdds];
        float x[kStepAdds];
        unsigned mask = step_adds_at(ray, gv, m, base + lane, g[r], off, x);
        for (int q = 0; q < kStepAdds; ++q)
          if (mask >> q & 1u) { s_off[total] = off[q]; s_x[total] = x[q]; ++total; }
      }
      for (int q = total - 1; q >= 0; --q) grad[s_off[q]] += s_x[q];
    }
  }
}
#define LAB_ARGS const int* lab, int64_t ls, int64_t ly, int64_t lz, int C
#define LAB Labels l{lab, ls, ly, lz, X, Y, Z}
extern "C" void jt_fwd_ch(VOL_ARGS, LAB_ARGS, float* out) {
  SETUP;
  LAB;
  for (int64_t r = 0; r < R; ++r) trace_fwd_ch(load_ray(rows, R, r), v, l, m, C, out + r, R);
}
extern "C" void jt_bwd_rays_ch(VOL_ARGS, LAB_ARGS, const float* g, float* out) {
  SETUP;
  LAB;
  float acc[kRows];
  for (int64_t r = 0; r < R; ++r) {
    trace_bwd_rays_ch(load_ray(rows, R, r), v, l, m, C, g + r, R, acc);
    for (int i = 0; i < kRows; ++i) out[i * R + r] = acc[i];
  }
}
extern "C" void jt_bwd_vol_ch(const float* rows, int64_t R, const float* g, float* grad,
                              int64_t gs, int64_t gy, int64_t gz, int X, int Y, int Z, float h,
                              int n, int blend, LAB_ARGS) {
  GradVolume gv{grad, gs, gy, gz, X, Y, Z};
  March m = mk(h, n, blend);
  LAB;
  for (int64_t r = 0; r < R; ++r) trace_bwd_vol_ch(load_ray(rows, R, r), gv, l, m, C, g + r, R);
}
"""


@pytest.fixture(scope="module")
def jtwin(tmp_path_factory):
    so = _build_twin(tmp_path_factory, "jtwin", _JOSEPH_TWIN_SRC)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    march = [ctypes.c_float, i32, i32]
    vol_args = [ptr, i64, ptr, i64, i64, i64, i32, i32, i32] + march
    so.jt_fwd.argtypes = vol_args + [ptr]
    so.jt_fwd_max.argtypes = vol_args + [ptr, ptr]
    so.jt_fwdgrad.argtypes = vol_args + [ptr, ptr]
    so.jt_bwd_rays.argtypes = vol_args + [ptr, ptr, ptr]
    so.jt_bwd_vol.argtypes = [ptr, i64, ptr, ptr, ptr, i64, i64, i64, i32, i32, i32] + march
    so.jt_bwd_vol_warp.argtypes = so.jt_bwd_vol.argtypes
    lab_args = [ptr, i64, i64, i64, i32]
    so.jt_fwd_ch.argtypes = vol_args + lab_args + [ptr]
    so.jt_bwd_rays_ch.argtypes = vol_args + lab_args + [ptr, ptr]
    so.jt_bwd_vol_ch.argtypes = [ptr, i64, ptr, ptr, i64, i64, i64, i32, i32, i32] + march \
        + lab_args
    for fn in (so.jt_fwd, so.jt_fwd_max, so.jt_fwdgrad, so.jt_bwd_rays, so.jt_bwd_vol,
               so.jt_bwd_vol_warp, so.jt_fwd_ch, so.jt_bwd_rays_ch, so.jt_bwd_vol_ch):
        fn.restype = None
    return so


class _JosephTwin:
    """The twin's five functions with the wrappers' signatures."""

    def __init__(self, so, rows, vol, axis, h, n):
        self.so, self.rows, self.vol, self.axis = so, rows.contiguous(), vol, axis
        self.march = (h, n, int(J.is_blend(h)))
        self.R = rows.shape[1]

    def _args(self):
        return (self.rows.data_ptr(), self.R, self.vol.data_ptr(),
                *_geom(self.vol, self.axis), *self.march)

    def fwd(self):
        out = torch.empty(self.R)
        self.so.jt_fwd(*self._args(), out.data_ptr())
        return out

    def fwd_max(self):
        val, arg = torch.empty(self.R), torch.empty(self.R, dtype=torch.int32)
        self.so.jt_fwd_max(*self._args(), val.data_ptr(), arg.data_ptr())
        return val, arg

    def fwdgrad(self, mip):
        out = torch.empty((8, self.R))
        arg = torch.empty(self.R, dtype=torch.int32) if mip else None
        self.so.jt_fwdgrad(*self._args(), out.data_ptr(), _ptr(arg))
        return out, arg

    def bwd_rays(self, g, arg):
        out = torch.empty((7, self.R))
        self.so.jt_bwd_rays(*self._args(), g.data_ptr(), _ptr(arg), out.data_ptr())
        return out

    def bwd_vol(self, g, arg, grad=None):
        grad = torch.zeros(self.vol.shape) if grad is None else grad
        self.so.jt_bwd_vol(self.rows.data_ptr(), self.R, g.data_ptr(), _ptr(arg),
                           grad.data_ptr(), *_geom(grad, self.axis), *self.march)
        return grad

    def _lab(self, lab, C):
        return (lab.data_ptr(), *_geom(lab, self.axis)[:3], C)

    def fwd_ch(self, lab, C):
        out = torch.full((C, self.R), float("nan"))  # the function zero-fills its column
        self.so.jt_fwd_ch(*self._args(), *self._lab(lab, C), out.data_ptr())
        return out

    def bwd_rays_ch(self, lab, g):
        out = torch.empty((7, self.R))
        self.so.jt_bwd_rays_ch(*self._args(), *self._lab(lab, g.shape[0]), g.data_ptr(),
                               out.data_ptr())
        return out

    def bwd_vol_ch(self, lab, g):
        grad = torch.zeros(self.vol.shape)
        self.so.jt_bwd_vol_ch(self.rows.data_ptr(), self.R, g.data_ptr(), grad.data_ptr(),
                              *_geom(grad, self.axis), *self.march, *self._lab(lab, g.shape[0]))
        return grad


def _check_joseph_twin(tw, rows, vol, axis, h, n, g):
    """All five twin functions against the plain versions, sum and MIP."""
    ref = J.joseph_fwd_plain(rows, vol, axis, h, n)
    np.testing.assert_allclose(tw.fwd(), ref, atol=1e-6 * ref.abs().max().item())
    val, arg = J.joseph_fwd_max_plain(rows, vol, axis, h, n)
    got_val, got_arg = tw.fwd_max()
    assert torch.equal(got_arg, arg)
    np.testing.assert_allclose(got_val, val, atol=1e-6 * val.abs().max().item())
    for mip in (False, True):
        ref_rows, ref_arg = J.joseph_fwdgrad_plain(rows, vol, axis, h, n, "max" if mip else "sum")
        got_rows, got_arg = tw.fwdgrad(mip)
        _assert_rows_close(got_rows, ref_rows)
        if mip:
            assert torch.equal(got_arg, ref_arg) and torch.equal(got_arg, arg)
        a = arg if mip else None
        _assert_rows_close(tw.bwd_rays(g, a), J.joseph_bwd_rays_plain(rows, vol, axis, h, n, g, a))
        ref_v = J.joseph_bwd_vol_plain(rows, g, vol.shape, axis, h, n, a)
        assert torch.count_nonzero(ref_v) > 0
        np.testing.assert_allclose(tw.bwd_vol(g, a), ref_v, atol=1e-5 * ref_v.abs().max().item())
    return arg


@pytest.mark.parametrize("h", [1.0, 2.0, 1.37, 0.6], ids=["h1", "h2", "h1.37", "h0.6"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_matches_plain(jtwin, axis, h):
    """trace_fwd, trace_fwd_max, trace_fwdgrad (sum and max), trace_bwd_rays
    and trace_bwd_vol (sum and MIP) at integer and fractional strides."""
    rng = np.random.default_rng(40 + axis)
    dims = (20, 24, 16)
    vol = torch.tensor(rng.uniform(0.1, 1.0, dims), dtype=torch.float32)
    src, tgt, w = _random_rays(rng, dims, axis, 200)
    rows = prep_rays(src, tgt, w, axis, dims, quadrature="joseph", h=h)
    n = int(-(-dims[axis] // h))
    g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32)
    arg = _check_joseph_twin(_JosephTwin(jtwin, rows, vol, axis, h, n), rows, vol, axis, h, n, g)
    assert (arg >= 0).sum() > 150  # most rays cross the volume


@pytest.mark.parametrize("h", [1.0, 0.5, 1.5])
def test_twin_joseph_step_range_margin(jtwin, h):
    """Rays entering through the y = -0.5 face, and leaving through the
    y = 15.5 face, at a march step: the in-slab decision of that step rests
    on rounding, and the per-ray step range must still include it."""
    vol = torch.tensor(np.random.default_rng(3).uniform(0.5, 1.0, (16, 16, 16)),
                       dtype=torch.float32)
    n = 32
    slope = 0.5 + np.linspace(0.0, 0.01, n)
    jit = np.linspace(0.0, 0.03, n)
    x_in, x_out = 5.0, 11.0  # steps of every h above
    y_in = -0.5 - slope * (x_in + 20.0)  # at x = -20, reaching y = -0.5 at x = x_in
    y_out = 15.5 + slope * (x_out + 20.0)  # falling to y = 15.5 at x = x_out
    src = np.concatenate([np.stack([np.full(n, -20.0), y_in, 8.0 + jit], 1),
                          np.stack([np.full(n, -20.0), y_out, 8.0 - jit], 1)])
    tgt = np.concatenate([np.stack([np.full(n, 40.0), y_in + 60.0 * slope, 8.3 + jit], 1),
                          np.stack([np.full(n, 40.0), y_out - 60.0 * slope, 7.7 - jit], 1)])
    src = torch.tensor(src, dtype=torch.float32)[:, None]
    tgt = torch.tensor(tgt, dtype=torch.float32)[:, None]
    rows = prep_rays(src, tgt, torch.ones((2 * n, 1, 1)), 0, vol.shape, quadrature="joseph",
                     h=h)
    steps = int(-(-16 // h))
    g = torch.ones(2 * n)
    tw = _JosephTwin(jtwin, rows, vol, 0, h, steps)
    ref = J.joseph_fwdgrad_plain(rows, vol, 0, h, steps)[0]
    assert (ref[7] > 0).all()
    _assert_rows_close(tw.fwdgrad(False)[0], ref)
    _check_joseph_twin(tw, rows, vol, 0, h, steps, g)


@pytest.mark.parametrize("h", [1.0, 1.37])
def test_twin_joseph_bwd_vol_writes_the_density_layout(jtwin, h):
    rng = np.random.default_rng(31)
    dims = (20, 24, 16)
    src, tgt, w = _random_rays(rng, dims, 1, 100)
    rows = prep_rays(src, tgt, w, 1, dims, quadrature="joseph", h=h)
    g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32)
    tw = _JosephTwin(jtwin, rows, torch.zeros(dims), 1, h, int(-(-dims[1] // h)))
    ref = tw.bwd_vol(g, None)
    grad_t = torch.zeros(dims[::-1], dtype=torch.float32).permute(2, 1, 0)  # Fortran order
    np.testing.assert_allclose(tw.bwd_vol(g, None, grad_t), ref,
                               atol=1e-6 * ref.abs().max().item())


def test_twin_joseph_missed_rays_are_zero(jtwin):
    vol = torch.ones((8, 8, 8))
    src = torch.tensor([[[-20.0, 50.0, 50.0]], [[-20.0, -30.0, 4.0]]])
    tgt = torch.tensor([[[30.0, 52.0, 51.0]], [[30.0, -31.0, 4.5]]])
    rows = prep_rays(src, tgt, torch.ones((2, 1, 1)), 0, vol.shape, quadrature="joseph")
    out, _ = _JosephTwin(jtwin, rows, vol, 0, 1.0, 8).fwdgrad(False)
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("h", [1.0, 0.5, 1.37], ids=["h1", "h0.5", "h1.37"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_channels_match_plain(jtwin, axis, h):
    """trace_fwd_ch, trace_bwd_rays_ch and trace_bwd_vol_ch against the plain
    versions, with labels -1..5 at C = 5 (-1 and 5 drop) held in another
    memory order than the density, and at h = 0.5 (a plane-pair tie at
    every odd step)."""
    rng = np.random.default_rng(50 + axis)
    dims = (20, 24, 16)
    vol = torch.tensor(rng.uniform(0.1, 1.0, dims), dtype=torch.float32)
    lab = torch.tensor(rng.integers(-1, 6, dims[::-1]), dtype=torch.int32).permute(2, 1, 0)
    src, tgt, w = _random_rays(rng, dims, axis, 200)
    rows = prep_rays(src, tgt, w, axis, dims, quadrature="joseph", h=h)
    n = int(-(-dims[axis] // h))
    tw = _JosephTwin(jtwin, rows, vol, axis, h, n)
    ref = J.joseph_fwd_ch_plain(rows, vol, lab, axis, h, n, 5)
    _assert_rows_close(tw.fwd_ch(lab, 5), ref)
    assert (ref > 0).sum(0).ge(3).sum() > 100  # most rays cross several structures
    g = torch.tensor(rng.normal(size=(5, rows.shape[1])), dtype=torch.float32)
    _assert_rows_close(tw.bwd_rays_ch(lab, g),
                       J.joseph_bwd_rays_ch_plain(rows, vol, lab, axis, h, n, g))
    ref_v = J.joseph_bwd_vol_ch_plain(rows, g, lab, dims, axis, h, n)
    assert torch.count_nonzero(ref_v) > 0
    np.testing.assert_allclose(tw.bwd_vol_ch(lab, g), ref_v, atol=1e-5 * ref_v.abs().max().item())


def _gpu_joseph_scene(h):
    vol, _, g = _gpu_scene()
    u, v = np.meshgrid(np.linspace(-3.3, 43.1, 32), np.linspace(-2.7, 35.9, 32), indexing="ij")
    tv = np.stack([u, v, np.full_like(u, 80.37)], -1).reshape(1, -1, 3)
    sv = np.array([[[20.3, 18.1, -50.2]]])
    w = np.linalg.norm(tv - sv, axis=-1)[:, None, :]
    rows = prep_rays(*(torch.tensor(x, dtype=torch.float32, device="cuda") for x in (sv, tv, w)),
                     2, vol.shape, quadrature="joseph", h=h)
    return vol, rows, g, int(-(-vol.shape[2] // h))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [1.0, 4.0, 1.37, 0.6])
@pytest.mark.parametrize("mode", ["sum", "mip"])
def test_cuda_joseph_kernels_match_plain_versions(mode, h):
    """On a card: the five Joseph kernels against their plain versions
    (values 1e-4 * max, argmax exact, rows 1e-3 * max|row|, density
    gradient 1e-4 * max, float atomics)."""
    vol, rows, g, n = _gpu_joseph_scene(h)
    val, arg = J.joseph_fwd_max(rows, vol, 2, h, n)
    ref_val, ref_arg = J.joseph_fwd_max_plain(rows, vol, 2, h, n)
    assert torch.equal(arg, ref_arg)
    torch.testing.assert_close(val, ref_val, rtol=0, atol=1e-4 * ref_val.abs().max().item())
    ref = J.joseph_fwd_plain(rows, vol, 2, h, n)
    torch.testing.assert_close(J.joseph_fwd(rows, vol, 2, h, n), ref, rtol=0,
                               atol=1e-4 * ref.abs().max().item())
    reduce = "max" if mode == "mip" else "sum"
    for label, axis, vol_a, rows_a in _gpu_fused_cases(quadrature="joseph", h=h):
        n_a = int(-(-vol_a.shape[axis] // h))
        got, arg_a = J.joseph_fwdgrad(rows_a, vol_a, axis, h, n_a, reduce)
        again, arg_again = J.joseph_fwdgrad(rows_a, vol_a, axis, h, n_a, reduce)
        ref, ref_arg = J.joseph_fwdgrad_plain(rows_a, vol_a, axis, h, n_a, reduce)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(again)), label
        if reduce == "max":
            assert torch.equal(arg_a, ref_arg) and torch.equal(arg_a, arg_again), label
        _assert_fused_close(got.cpu(), ref.cpu(), 7, label)
    got_rows, got_arg = J.joseph_fwdgrad(rows, vol, 2, h, n, reduce)
    ref_rows, ref_arg = J.joseph_fwdgrad_plain(rows, vol, 2, h, n, reduce)
    assert (got_arg is None) == (ref_arg is None)
    if got_arg is not None:
        assert torch.equal(got_arg, ref_arg)
    a = arg if mode == "mip" else None
    for got_k, ref_k in zip(got_rows, ref_rows):
        torch.testing.assert_close(got_k, ref_k, rtol=0, atol=1e-3 * ref_k.abs().max().item() + 1e-30)
    got_b = J.joseph_bwd_rays(rows, vol, 2, h, n, g, a)
    ref_b = J.joseph_bwd_rays_plain(rows, vol, 2, h, n, g, a)
    for got_k, ref_k in zip(got_b, ref_b):
        torch.testing.assert_close(got_k, ref_k, rtol=0, atol=1e-3 * ref_k.abs().max().item() + 1e-30)
    got_v = J.joseph_bwd_vol(rows, g, vol.shape, 2, h, n, a)
    ref_v = J.joseph_bwd_vol_plain(rows, g, vol.shape, 2, h, n, a)
    torch.cuda.synchronize()
    assert got_v.is_contiguous() and got_v.shape == vol.shape
    torch.testing.assert_close(got_v, ref_v, rtol=0, atol=1e-4 * ref_v.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("h", [1.0, 4.0, 1.37, 0.5, 0.26])
@pytest.mark.parametrize("n_channels", [5, 3])
def test_cuda_joseph_channel_kernels_match_plain_versions(n_channels, h):
    """On a card: joseph_fwd_ch and joseph_bwd_rays_ch equal their plain
    versions (the same float32 operations in the same order), and
    joseph_bwd_vol_ch to 1e-6 * max (float atomics); labels 0..4, so 3 and
    4 drop at n_channels = 3."""
    vol, rows, _, n = _gpu_joseph_scene(h)
    rng = np.random.default_rng(8)
    lab = torch.tensor(rng.integers(0, 5, tuple(vol.shape)), dtype=torch.int32, device="cuda")
    g = torch.tensor(rng.normal(size=(n_channels, rows.shape[1])), dtype=torch.float32,
                     device="cuda")
    got = J.joseph_fwd_ch(rows, vol, lab, 2, h, n, n_channels)
    ref = J.joseph_fwd_ch_plain(rows, vol, lab, 2, h, n, n_channels)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(J.joseph_bwd_rays_ch(rows, vol, lab, 2, h, n, g),
                               J.joseph_bwd_rays_ch_plain(rows, vol, lab, 2, h, n, g),
                               rtol=0, atol=0)
    got_v = J.joseph_bwd_vol_ch(rows, g, lab, vol.shape, 2, h, n)
    ref_v = J.joseph_bwd_vol_ch_plain(rows, g, lab, vol.shape, 2, h, n)
    torch.cuda.synchronize()
    assert got_v.is_contiguous() and torch.count_nonzero(ref_v) > 0
    torch.testing.assert_close(got_v, ref_v, rtol=0, atol=1e-6 * ref_v.abs().max().item())


# -----------------------------------------------------------------------------
# The density-gradient scatters split over a warp's lanes
# -----------------------------------------------------------------------------

_WARP_DIMS = (72, 70, 68)  # every march axis longer than 64 slabs


def _mixed_rays(rng, dims, axis, n):
    """``n`` rays of each of three kinds along ``axis``: long (the whole march
    axis at gentle slopes), short (entering through a transverse face 3 to
    25 slabs before the far end) and missing the volume."""
    X = dims[axis]
    ya, za = [a for a in range(3) if a != axis]
    Y, Z = dims[ya], dims[za]
    s_lo, s_hi = -30.0 - 5 * rng.random(3 * n), X + 30.0 + 5 * rng.random(3 * n)
    # Transverse position c + slope * (s - s_c) on each transverse axis.
    s_c = np.concatenate([np.full(n, X / 2), X - rng.uniform(3.0, 25.0, n), np.full(n, X / 2)])
    cy = np.concatenate([rng.uniform(0.35, 0.65, n) * Y, np.full(n, -0.5 + 0.0123),
                         -20.0 - 5 * rng.random(n)])
    my = np.concatenate([rng.uniform(-0.3, 0.3, n), np.full(n, 0.9), np.zeros(n)])
    cz = rng.uniform(0.35, 0.65, 3 * n) * Z
    mz = rng.uniform(-0.2, 0.2, 3 * n)
    pts = []
    for s in (s_lo, s_hi):
        p = np.zeros((3 * n, 3))
        p[:, axis] = s
        p[:, ya] = cy + my * (s - s_c)
        p[:, za] = cz + mz * (s - s_c)
        pts.append(torch.tensor(p[:, None], dtype=torch.float32))
    w = torch.tensor(rng.uniform(0.5, 2.0, (3 * n, 1, 1)), dtype=torch.float32)
    return pts[0], pts[1], w


def _slab_counts(rows):
    """Each ray's number of slabs inside the volume (0 for a miss)."""
    r = dict(zip(("a", "b", "amin", "amax"), rows[[0, 1, 7, 8]].double()))
    return torch.clamp((r["amax"] - r["amin"]) / r["a"].abs(), min=0.0)


def _warp_scene(axis, seed, device="cpu", **prep):
    rng = np.random.default_rng(seed)
    vol = torch.tensor(rng.uniform(0.1, 1.0, _WARP_DIMS), dtype=torch.float32, device=device)
    src, tgt, w = _mixed_rays(rng, _WARP_DIMS, axis, 40)
    rows = prep_rays(src.to(device), tgt.to(device), w.to(device), axis, _WARP_DIMS, **prep)
    g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32, device=device)
    n = _slab_counts(rows)
    assert (n > 64).any() and ((n > 0) & (n < 32)).any() and (n == 0).any()
    return vol, rows, g


@pytest.mark.parametrize("mode", ["sum", "mip"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_siddon_warp_scatter_matches_plain(twin, axis, mode):
    """slab_adds in the warp kernel's order (passes of 32 slabs, each pass's
    adds in path order, made last to first) against siddon_bwd_vol_plain:
    long, short and missing rays."""
    vol, rows, g = _warp_scene(axis, 60 + axis)
    arg = siddon_fwd_max_plain(rows, vol, axis)[1] if mode == "mip" else None
    ref = siddon_bwd_vol_plain(rows, g, _WARP_DIMS, axis, arg)
    got = torch.zeros(_WARP_DIMS)
    twin.twin_bwd_vol_warp(rows.data_ptr(), rows.shape[1], g.data_ptr(), _ptr(arg),
                           got.data_ptr(), *_geom(got, axis))
    assert torch.count_nonzero(ref) > 0
    np.testing.assert_allclose(got, ref, atol=1e-5 * ref.abs().max().item())


_WARP_H = pytest.mark.parametrize("h", [1.0, 4.0, 1.37, 0.6, 0.26],
                                  ids=["h1", "h4", "h1.37", "h0.6", "h0.26"])


def _joseph_warp_scene(axis, h, seed, device="cpu"):
    vol, rows, g = _warp_scene(axis, seed, device, quadrature="joseph", h=h)
    return vol, rows, g, int(-(-_WARP_DIMS[axis] // h))


@_WARP_H
@pytest.mark.parametrize("mode", ["sum", "mip"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_warp_scatter_matches_plain(jtwin, axis, mode, h):
    """step_adds_at in the warp kernel's order (passes of 32 steps, each
    pass's adds in path order, made last to first) against
    joseph_bwd_vol_plain: long, short and missing rays, at integer,
    fractional and oversampling strides."""
    vol, rows, g, n = _joseph_warp_scene(axis, h, 70 + axis)
    arg = J.joseph_fwd_max_plain(rows, vol, axis, h, n)[1] if mode == "mip" else None
    ref = J.joseph_bwd_vol_plain(rows, g, _WARP_DIMS, axis, h, n, arg)
    got = torch.zeros(_WARP_DIMS)
    jtwin.jt_bwd_vol_warp(rows.data_ptr(), rows.shape[1], g.data_ptr(), _ptr(arg),
                          got.data_ptr(), *_geom(got, axis), h, n, int(J.is_blend(h)))
    assert torch.count_nonzero(ref) > 0
    np.testing.assert_allclose(got, ref, atol=1e-5 * ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sum", "mip"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cuda_siddon_warp_scatter_matches_plain(axis, mode):
    """On a card: siddon_bwd_vol (one warp per ray) on the mixed rays above,
    atol 1e-4 * max (float atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vol, rows, g = _warp_scene(axis, 60 + axis, "cuda")
    arg = K.siddon_fwd_max_plain(rows, vol, axis)[1] if mode == "mip" else None
    got = K.siddon_bwd_vol(rows, g, vol.shape, axis, arg)
    ref = K.siddon_bwd_vol_plain(rows, g, vol.shape, axis, arg)
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.count_nonzero(ref) > 0
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * ref.abs().max().item())


@pytest.mark.gpu
@_WARP_H
@pytest.mark.parametrize("mode", ["sum", "mip"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cuda_joseph_warp_scatter_matches_plain(axis, mode, h):
    """On a card: joseph_bwd_vol (one warp per ray) on the mixed rays above,
    atol 1e-4 * max (float atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vol, rows, g, n = _joseph_warp_scene(axis, h, 70 + axis, "cuda")
    arg = J.joseph_fwd_max_plain(rows, vol, axis, h, n)[1] if mode == "mip" else None
    got = J.joseph_bwd_vol(rows, g, vol.shape, axis, h, n, arg)
    ref = J.joseph_bwd_vol_plain(rows, g, vol.shape, axis, h, n, arg)
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.count_nonzero(ref) > 0
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * ref.abs().max().item())


# -----------------------------------------------------------------------------
# The forward gathers on the bricked copy (csrc/brick.cuh)
# -----------------------------------------------------------------------------

_BRICK_TWIN_SRC = r"""
#include <type_traits>
#include "joseph.cuh"
#include "siddon.cuh"
#define BRICK_ARGS const float* bvol, int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z
// f(std::integral_constant<int, A>()) for march axis A = axis.
template <class F>
static void with_axis(int axis, F f) {
  switch (axis) {
    case 0: f(std::integral_constant<int, 0>()); break;
    case 1: f(std::integral_constant<int, 1>()); break;
    default: f(std::integral_constant<int, 2>()); break;
  }
}
// trace_fwd on the bricked copy with `unroll` slabs (steps) in flight; 0
// takes the kernels' own count (kFwdSlabs, kFwdSteps).
template <class F>
static void each_unroll(int unroll, F f) {
  switch (unroll) {
    case 1: f(std::integral_constant<int, 1>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    default: f(std::integral_constant<int, 0>()); break;
  }
}
extern "C" void bt_siddon(int unroll, const float* rows, int64_t R, BRICK_ARGS, float* out) {
  with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    each_unroll(unroll, [&](auto u) {
      constexpr int U = decltype(u)::value ? decltype(u)::value : siddon::kFwdSlabs;
      for (int64_t r = 0; r < R; ++r)
        out[r] = siddon::trace_fwd<U>(siddon::load_ray(rows, R, r), v);
    });
  });
}
extern "C" void bt_joseph(int unroll, const float* rows, int64_t R, BRICK_ARGS, float h, int n,
                          int blend, float* out) {
  joseph::March m;
  m.h = h;
  m.n_steps = n;
  m.blend = blend != 0;
  with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    each_unroll(unroll, [&](auto u) {
      constexpr int U = decltype(u)::value ? decltype(u)::value : joseph::kFwdSteps;
      for (int64_t r = 0; r < R; ++r)
        out[r] = joseph::trace_fwd<U>(joseph::load_ray(rows, R, r), v, m);
    });
  });
}
"""

_UNROLLS = (0, 1, 2, 4)  # 0: the kernels' own count


@pytest.fixture(scope="module")
def btwin(tmp_path_factory):
    """The twin of the bricked trace_fwd for a brick shape: brick.cuh's
    compile-time shape set with -D, one build per shape."""
    built = {}

    def get(shape):
        if shape not in built:
            logs = [b.bit_length() - 1 for b in shape]
            so = _build_twin(tmp_path_factory, "btwin", _BRICK_TWIN_SRC,
                             [f"BRICK_L{d}={logs[d]}" for d in range(3)])
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            bvol = [ptr] + [i32] * 7
            so.bt_siddon.argtypes = [i32, ptr, i64] + bvol + [ptr]
            so.bt_joseph.argtypes = [i32, ptr, i64] + bvol + [ctypes.c_float, i32, i32, ptr]
            so.bt_siddon.restype = so.bt_joseph.restype = None
            built[shape] = so
        return built[shape]

    return get


def _brick_copy(vol, shape):
    """The bricked copy of ``vol`` in bricks of ``shape`` (the layout of
    brick.brick_density_plain, for any brick shape a twin is built with)."""
    pad = [-e % b for e, b in zip(vol.shape, shape)]
    padded = torch.nn.functional.pad(vol, (0, pad[2], 0, pad[1], 0, pad[0]))
    split = [m for e, p, b in zip(vol.shape, pad, shape) for m in ((e + p) // b, b)]
    data = padded.reshape(split).permute(0, 2, 4, 1, 3, 5).contiguous()
    return brick.BrickedDensity(data, tuple(vol.shape))


def _bricked_fwd(btwin, rows, vol, axis, unroll, brick_shape, march=None):
    """The twin's trace_fwd on ``vol``'s bricked copy; ``march`` (h, n) for Joseph."""
    so = btwin(brick_shape)
    rows = rows.contiguous()
    R = rows.shape[1]
    bv = brick_density(vol) if brick_shape == brick.BRICK else _brick_copy(vol, brick_shape)
    out = torch.full((R,), float("nan"))
    head = (unroll, rows.data_ptr(), R, bv.data.data_ptr(), *bv.args(axis))
    if march is None:
        so.bt_siddon(*head, out.data_ptr())
    else:
        h, n = march
        so.bt_joseph(*head, h, n, int(J.is_blend(h)), out.data_ptr())
    return out


def _bits(t):
    return t.contiguous().view(torch.int32)


def _fwd_rays(rng, dims, axis, **prep):
    """Rows of the bricked-forward cases along ``axis``: random off-grid rays,
    long, short (entering through a transverse face near the far end) and
    missing rays, rays entering mid-slab through the y = -0.5 face, and last
    a ray of NaN rows."""
    parts = [_random_rays(rng, dims, axis, 60), _mixed_rays(rng, dims, axis, 12)]
    ya = [a for a in range(3) if a != axis][0]
    n = 16
    x_e = 0.4 * dims[axis] + 0.3  # where the rays cross y = -0.5: inside slab round(x_e)
    slope = 0.8 + np.linspace(0.0, 0.02, n)
    pts = []
    for s in (-50.0, dims[axis] + 50.0):
        p = np.zeros((n, 3))
        p[:, axis] = s
        p[:, ya] = -0.5 + slope * (s - x_e)
        p[:, 3 - axis - ya] = 0.5 * dims[3 - axis - ya] + np.linspace(0.0, 0.02, n)
        pts.append(torch.tensor(p[:, None], dtype=torch.float32))
    parts.append((pts[0], pts[1], torch.ones((n, 1, 1))))
    rows = torch.cat([prep_rays(s, t, w, axis, dims, **prep) for s, t, w in parts], 1)
    return torch.cat([rows, torch.full((9, 1), float("nan"))], 1)


# Extents that are not whole bricks of any shape below.
_BRICK_DIMS = (21, 23, 13)
_BRICKS = pytest.mark.parametrize("brick_shape", [(4, 4, 2), (4, 4, 4), (2, 8, 1)],
                                  ids=["4x4x2", "4x4x4", "2x8x1"])


def _densities(rng, dims):
    """The same random density contiguous and in Fortran order (permuted)."""
    vol = torch.tensor(rng.uniform(0.1, 1.0, dims), dtype=torch.float32)
    return vol, vol.permute(2, 1, 0).contiguous().permute(2, 1, 0)


@_BRICKS
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_siddon_bricked_equals_strided(twin, btwin, axis, brick_shape):
    """siddon::trace_fwd on the bricked copy, at every unroll, equals the
    strided serial trace_fwd bit for bit (contiguous and permuted density,
    extents not whole bricks, partial entry slabs, missing and NaN rays),
    and the plain version to 1e-6 * max on the finite rays."""
    rng = np.random.default_rng(80 + axis)
    vol, vol_f = _densities(rng, _BRICK_DIMS)
    rows = _fwd_rays(rng, _BRICK_DIMS, axis)
    ref = _run_twin(twin, False, rows, vol, axis)
    assert (ref[:-1] == 0).any() and (ref[:-1] > 0).sum() > 80
    assert torch.equal(_bits(_run_twin(twin, False, rows, vol_f, axis)), _bits(ref))
    for unroll in _UNROLLS:
        for v in (vol, vol_f):
            got = _bricked_fwd(btwin, rows, v, axis, unroll, brick_shape)
            assert torch.equal(_bits(got), _bits(ref)), (unroll, v.is_contiguous())
    plain = siddon_fwd_plain(rows[:, :-1], vol, axis)
    np.testing.assert_allclose(ref[:-1], plain, atol=1e-6 * plain.abs().max().item())


@_BRICKS
@pytest.mark.parametrize("h", [1.0, 4.0, 1.37, 0.6, 0.26],
                         ids=["h1", "h4", "h1.37", "h0.6", "h0.26"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_bricked_equals_strided(jtwin, btwin, axis, h, brick_shape):
    """joseph::trace_fwd on the bricked copy, at every unroll, equals the
    strided serial trace_fwd bit for bit, at integer h and at fractional h
    (whose last steps lerp toward plane X, which reads 0), and the plain
    version to 1e-6 * max on the finite rays."""
    rng = np.random.default_rng(90 + axis)
    vol, vol_f = _densities(rng, _BRICK_DIMS)
    rows = _fwd_rays(rng, _BRICK_DIMS, axis, quadrature="joseph", h=h)
    n = int(-(-_BRICK_DIMS[axis] // h))
    if h < 1:
        assert (n - 1) * np.float32(h) > _BRICK_DIMS[axis] - 1  # the pair at plane X
    ref = _JosephTwin(jtwin, rows, vol, axis, h, n).fwd()
    assert ref[-1] == 0 and (ref[:-1] > 0).sum() > 80
    assert torch.equal(_bits(_JosephTwin(jtwin, rows, vol_f, axis, h, n).fwd()), _bits(ref))
    for unroll in _UNROLLS:
        for v in (vol, vol_f):
            got = _bricked_fwd(btwin, rows, v, axis, unroll, brick_shape, (h, n))
            assert torch.equal(_bits(got), _bits(ref)), (unroll, v.is_contiguous())
    plain = J.joseph_fwd_plain(rows[:, :-1], vol, axis, h, n)
    np.testing.assert_allclose(ref[:-1], plain, atol=1e-6 * plain.abs().max().item())


@pytest.mark.parametrize("dims", [(21, 23, 13), (8, 8, 4), (1, 5, 2), (4, 4, 4), (5, 1, 9),
                                  (16, 3, 7), (2, 9, 1), (12, 12, 12), (3, 17, 6)])
def test_brick_density_matches_index_gather(dims):
    """Every voxel (i0, i1, i2) of the density, contiguous or permuted, sits
    at [i0 // b0, i1 // b1, i2 // b2, i0 % b0, i1 % b1, i2 % b2] of the copy,
    the padding is 0, and the C arguments are each march-permuted axis's
    brick stride and extent (the last axis's brick stride is one brick, as
    the kernels take it, wherever that axis has more than one)."""
    rng = np.random.default_rng(sum(dims))
    bs = brick.BRICK
    for vol in _densities(rng, dims):
        bv = brick_density(vol)
        assert bv.shape == dims and bv.data.is_contiguous()
        assert tuple(bv.data.shape) == (*(-(-e // b) for e, b in zip(dims, bs)), *bs)
        idx = torch.meshgrid(*(torch.arange(e) for e in dims), indexing="ij")
        at = [i // b for i, b in zip(idx, bs)] + [i % b for i, b in zip(idx, bs)]
        assert torch.equal(bv.data[tuple(at)], vol)
        inside = torch.zeros(bv.data.shape, dtype=torch.bool)
        inside[tuple(at)] = True
        assert torch.count_nonzero(bv.data[~inside]) == 0
        assert bv.data.shape[2] == 1 or bv.data.stride(2) == bs[0] * bs[1] * bs[2]
        for axis in range(3):
            perm = march_perm(axis)
            assert bv.args(axis) == [axis, *(bv.data.stride(p) for p in perm),
                                     *(dims[p] for p in perm)]
        # The twins' bricking at other shapes lays voxels out the same way.
        for shape in ((4, 4, 2), (2, 8, 1)):
            data = _brick_copy(vol, shape).data
            at = [i // b for i, b in zip(idx, shape)] + [i % b for i, b in zip(idx, shape)]
            assert torch.equal(data[tuple(at)], vol)
            assert torch.count_nonzero(data) == torch.count_nonzero(vol)  # zero padding


def test_brick_shape_matches_header():
    """ops/kernels/brick.py's BRICK is the shape csrc/brick.cuh compiles."""
    text = (build.CSRC / "brick.cuh").read_text()
    logs = [int(re.search(rf"#define BRICK_L{d} (\d+)", text).group(1)) for d in range(3)]
    assert tuple(1 << l for l in logs) == brick.BRICK


def test_bricked_cache_tracks_writes():
    """brick.bricked hands back the same copy for an unchanged density and a
    fresh one after add_, copy_, a torch.optim.Adam step and for a new tensor
    at the address of a freed one; it holds no density alive."""
    clear_cache()
    rng = np.random.default_rng(12)
    dims = (9, 6, 5)

    def fresh(d, before):
        got = bricked(d)
        assert got.data is not before.data
        assert torch.equal(got.data, brick_density(d).data)
        return got

    d = torch.tensor(rng.uniform(size=dims), dtype=torch.float32)
    first = bricked(d)
    assert bricked(d).data is first.data and bricked(d.detach()).data is first.data
    b = fresh(d.add_(1.0), first)
    b = fresh(d.copy_(torch.tensor(rng.uniform(size=dims), dtype=torch.float32)), b)
    assert bricked(d).data is b.data

    p = torch.tensor(rng.uniform(size=dims), dtype=torch.float32, requires_grad=True)
    opt = torch.optim.Adam([p], lr=0.1)
    b = bricked(p)
    assert b.data.grad_fn is None and not b.data.requires_grad
    (p ** 2).sum().backward()
    opt.step()
    fresh(p, b)

    arr = rng.uniform(size=dims).astype(np.float32)
    old = torch.from_numpy(arr)
    b = bricked(old)
    ptr, n_before = old.data_ptr(), len(brick._entries)
    del old  # the copy goes with the density
    assert len(brick._entries) == n_before - 1
    arr[:] = rng.uniform(size=dims)  # a write torch does not see
    new = torch.from_numpy(arr)  # same address, version, shape and strides
    assert new.data_ptr() == ptr and new._version == 0
    fresh(new, b)
    clear_cache()
    assert not brick._entries


def _gpu_fwd_scenes(axis):
    """(label, density, rows, march) on the card: a 64x64 detector plus the
    mixed rays on the warp-case volume, and a 200x200 detector on a random
    128x128x64 volume, each along ``axis``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7 + axis)
    out = []
    for label, dims, side in (("64^2 mixed", _WARP_DIMS, 64), ("200^2", (128, 128, 64), 200)):
        vol = torch.tensor(rng.uniform(0.1, 1.0, dims), dtype=torch.float32, device="cuda")
        ya, za = [a for a in range(3) if a != axis]
        u, v = np.meshgrid(np.linspace(-3.3, dims[ya] + 3.1, side),
                           np.linspace(-2.7, dims[za] + 1.9, side), indexing="ij")
        tv = np.zeros((1, side * side, 3))
        tv[0, :, ya], tv[0, :, za] = u.reshape(-1), v.reshape(-1)
        tv[0, :, axis] = dims[axis] + 40.37
        sv = np.zeros((1, 1, 3))
        sv[0, 0, ya], sv[0, 0, za], sv[0, 0, axis] = dims[ya] / 2 + 0.3, dims[za] / 2 - 0.1, -50.2
        w = np.linalg.norm(tv - sv, axis=-1)[:, None, :]
        geo = [torch.tensor(x, dtype=torch.float32, device="cuda") for x in (sv, tv, w)]
        extra = _mixed_rays(rng, dims, axis, 40) if side == 64 else None
        out.append((label, vol, geo, extra))
    return out


def _gpu_fused_cases(**prep):
    """(label, march axis, density, rows) on the card for the fused kernels:
    ``_gpu_fwd_scenes`` of every march axis, the 64x64 detector with its
    mixed rays and the 200x200 one (``prep``: prep_rays' quadrature)."""
    out = []
    for axis in (0, 1, 2):
        for label, vol, geo, extra in _gpu_fwd_scenes(axis):
            rows = prep_rays(*geo, axis, vol.shape, **prep)
            if extra is not None:
                rows = torch.cat([rows, prep_rays(*(t.cuda() for t in extra), axis, vol.shape,
                                                  **prep)], 1)
            out.append((f"{label} axis {axis}", axis, vol, rows))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [0, 2])
def test_cuda_siddon_fwd_bricked_matches_plain(axis):
    """On a card: siddon_fwd (bricked copy) against its plain version, atol
    1e-4 * max, at 64x64 with mixed rays and at 200x200."""
    for label, vol, geo, extra in _gpu_fwd_scenes(axis):
        rows = prep_rays(*geo, axis, vol.shape)
        if extra is not None:
            rows = torch.cat([rows, prep_rays(*(t.cuda() for t in extra), axis, vol.shape)], 1)
        ref = K.siddon_fwd_plain(rows, vol, axis)
        got = K.siddon_fwd(rows, vol, axis)
        torch.cuda.synchronize()
        assert (ref > 0).sum() > rows.shape[1] // 2, label
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * ref.abs().max().item(),
                                   msg=label)


@pytest.mark.gpu
@pytest.mark.parametrize("h", [1.0, 4.0, 1.37, 0.6])
@pytest.mark.parametrize("axis", [0, 2])
def test_cuda_joseph_fwd_bricked_matches_plain(axis, h):
    """On a card: joseph_fwd (bricked copy) against its plain version, atol
    1e-4 * max, at 64x64 with mixed rays and at 200x200."""
    for label, vol, geo, extra in _gpu_fwd_scenes(axis):
        rows = prep_rays(*geo, axis, vol.shape, quadrature="joseph", h=h)
        if extra is not None:
            rows = torch.cat([rows, prep_rays(*(t.cuda() for t in extra), axis, vol.shape,
                                              quadrature="joseph", h=h)], 1)
        n = int(-(-vol.shape[axis] // h))
        ref = J.joseph_fwd_plain(rows, vol, axis, h, n)
        got = J.joseph_fwd(rows, vol, axis, h, n)
        torch.cuda.synchronize()
        assert (ref > 0).sum() > rows.shape[1] // 2, label
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * ref.abs().max().item(),
                                   msg=label)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(21, 23, 13), (8, 8, 4), (130, 67, 133)])
def test_cuda_brick_copy_matches_plain(dims):
    """On a card: brick_copy (csrc/brick.cu) equals the plain copy bit for
    bit, contiguous and permuted, on extents that are not whole bricks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for vol in _densities(np.random.default_rng(3), dims):
        # .cuda() keeps the permuted density's Fortran strides
        vol = vol.cuda()
        launches = brick_density.launches
        got = brick_density(vol)
        ref = brick_density_plain(vol)
        torch.cuda.synchronize()
        assert brick_density.launches == launches + 1 and got.shape == ref.shape
        assert torch.equal(got.data, ref.data)


# -----------------------------------------------------------------------------
# The fused pose kernels: G lanes a ray on the bricked copy (csrc/lanes.cuh)
# -----------------------------------------------------------------------------

_FUSED_TWIN_SRC = r"""
#include <string.h>
#include <type_traits>
#include "joseph.cuh"
#include "siddon.cuh"
#define BRICK_ARGS const float* bvol, int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z
template <int N>
using IC = std::integral_constant<int, N>;
// f(G, U) of the variant: G lanes a ray and U slabs (steps) in flight, 0
// taking the kernel's own (kFusedLanes, kFusedSlabs or kFusedSteps).
template <class F>
static void with_variant(int variant, F f) {
  switch (variant) {
    case 0: f(IC<1>(), IC<0>()); break;
    case 1: f(IC<2>(), IC<0>()); break;
    case 2: f(IC<8>(), IC<0>()); break;
    case 3: f(IC<32>(), IC<0>()); break;
    case 4: f(IC<0>(), IC<1>()); break;
    case 5: f(IC<0>(), IC<2>()); break;
    default: f(IC<0>(), IC<4>()); break;
  }
}
// One ray's fused march as fwdgrad_lanes runs it, lane after lane: passes
// of G * U slabs (steps) from lo, each lane's summands (fused_terms) laid
// out by row and by slab as in the hand-over, each lane's rows taking them
// (take_in_order), and row k read from lane k % G's slot k / G. MIP: each
// lane's first maximum, then the tree; returns whether the lanes' maxima
// differ after it.
template <int G, int U, int N, class Terms>
static bool lanes_march(int lo, int hi, bool mip, Terms terms, float out[N], int* arg) {
  constexpr int S = G * U;
  float acc[G][lanes::kSlots<G, N>] = {};
  float best[G][N] = {};
  int best_p[G];
  for (int j = 0; j < G; ++j) best_p[j] = -1;
  for (int base = lo; base < hi; base += S) {
    float hand[N * S];
    for (int j = 0; j < G; ++j) {
      float tm[U][N];
      terms(base + j, tm);
      for (int u = 0; u < U; ++u) {
        for (int k = 0; k < N; ++k) hand[k * S + u * G + j] = tm[u][k];
        if (tm[u][N - 1] > best[j][N - 1]) {
          memcpy(best[j], tm[u], sizeof(best[j]));
          best_p[j] = base + u * G + j;
        }
      }
    }
    for (int j = 0; j < G; ++j) lanes::take_in_order<G, N, S>(hand, S, j, acc[j]);
  }
  if (!mip) {
    for (int k = 0; k < N; ++k) out[k] = acc[k % G][k / G];
    return false;
  }
  lanes::combine_max_lanes<G, N, N - 1>(best, best_p);
  bool differ = false;
  for (int j = 1; j < G; ++j)
    differ |= memcmp(best[j], best[0], sizeof(best[0])) != 0 || best_p[j] != best_p[0];
  for (int k = 0; k < N; ++k) out[k] = best[k % G][k];
  *arg = best_p[0];
  return differ;
}
extern "C" void ft_siddon(int variant, const float* rows, int64_t R, BRICK_ARGS, float* out) {
  brick::with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    with_variant(variant, [&](auto g, auto u) {
      constexpr int G = decltype(g)::value ? decltype(g)::value : siddon::kFusedLanes;
      constexpr int U = decltype(u)::value ? decltype(u)::value : siddon::kFusedSlabs;
      constexpr int N = siddon::kFusedRows;
      for (int64_t r = 0; r < R; ++r) {
        siddon::Ray ray = siddon::load_ray(rows, R, r);
        int lo, hi;
        siddon::slab_range(ray, X, &lo, &hi);
        float o[N];
        lanes_march<G, U, N>(lo, hi, false, [&](int s0, float (*tm)[N]) {
          siddon::fused_terms<U>(ray, v, s0, G, hi, tm);
        }, o, nullptr);
        for (int k = 0; k < N; ++k) out[k * R + r] = o[k];
      }
    });
    return 0;
  });
}
// Returns the number of rays whose lanes' maxima differ after the tree.
extern "C" int ft_joseph(int variant, int mip, const float* rows, int64_t R, BRICK_ARGS, float h,
                         int n, int blend, float* out, int* arg) {
  joseph::March m;
  m.h = h;
  m.n_steps = n;
  m.blend = blend != 0;
  int bad = 0;
  brick::with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    with_variant(variant, [&](auto g, auto u) {
      constexpr int G = decltype(g)::value ? decltype(g)::value : joseph::kFusedLanes;
      constexpr int U = decltype(u)::value ? decltype(u)::value : joseph::kFusedSteps;
      constexpr int N = joseph::kFusedRows;
      for (int64_t r = 0; r < R; ++r) {
        joseph::Ray ray = joseph::load_ray(rows, R, r);
        int lo, hi;
        joseph::step_range(ray, m, &lo, &hi);
        float o[N];
        int best = -1;
        bad += lanes_march<G, U, N>(lo, hi, mip != 0, [&](int p0, float (*tm)[N]) {
          joseph::fused_terms<U>(ray, v, m, p0, G, hi, tm);
        }, o, &best);
        for (int i = 0; i < N; ++i) out[i * R + r] = o[i];
        if (mip) arg[r] = best;
      }
    });
    return 0;
  });
  return bad;
}
"""

# (G, U) of each variant of the twin (None: the kernel's own), in its order.
_FUSED_VARIANTS = ((1, None), (2, None), (8, None), (32, None),
                   (None, 1), (None, 2), (None, 4))
_LANES = (0, 1, 2, 3)  # G = 1, 2, 8, 32, each with the kernel's U
_UNROLLED = (4, 5, 6)  # the kernel's G with U = 1, 2, 4


@pytest.fixture(scope="module")
def ftwin(tmp_path_factory):
    """The twin of the fused kernels' lanes (the package's brick shape)."""
    so = _build_twin(tmp_path_factory, "ftwin", _FUSED_TWIN_SRC)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    bvol = [ptr] + [i32] * 7
    so.ft_siddon.argtypes = [i32, ptr, i64] + bvol + [ptr]
    so.ft_joseph.argtypes = [i32, i32, ptr, i64] + bvol + [ctypes.c_float, i32, i32, ptr, ptr]
    so.ft_siddon.restype = None
    so.ft_joseph.restype = i32
    return so


def _fused_siddon(ftwin, variant, rows, vol, axis):
    """(10, R) of the twin's lanes on ``vol``'s bricked copy."""
    rows = rows.contiguous()
    bv = brick_density(vol)
    out = torch.full((10, rows.shape[1]), float("nan"))
    ftwin.ft_siddon(variant, rows.data_ptr(), rows.shape[1], bv.data.data_ptr(), *bv.args(axis),
                    out.data_ptr())
    return out


def _fused_joseph(ftwin, variant, mip, rows, vol, axis, h, n):
    """((8, R), argmax or None) of the twin's lanes on ``vol``'s bricked copy."""
    rows = rows.contiguous()
    bv = brick_density(vol)
    out = torch.full((8, rows.shape[1]), float("nan"))
    arg = torch.full((rows.shape[1],), -2, dtype=torch.int32) if mip else None
    bad = ftwin.ft_joseph(variant, int(mip), rows.data_ptr(), rows.shape[1], bv.data.data_ptr(),
                          *bv.args(axis), h, n, int(J.is_blend(h)), out.data_ptr(), _ptr(arg))
    assert bad == 0, f"{bad} rays' lanes hold different maxima after the tree"
    return out, arg


def _assert_fused_close(got, ref, value_row, what):
    """The fused kernels' tolerance against the plain versions: gradient
    rows 1e-3 * max|row|, the value 1e-4 * max|value|."""
    for k in range(ref.shape[0]):
        rel = 1e-4 if k == value_row else 1e-3
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=rel * ref[k].abs().max().item() + 1e-30,
                                   err_msg=f"{what} row {k}")


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_siddon_fused_lanes_match_plain(twin, ftwin, axis):
    """The fused kernel's lanes on the bricked copy (fused_terms and
    take_in_order, passes of G * U slabs), at G = 1, 2, 8 and 32 lanes a ray
    and at the kernel's G with U = 1, 2 and 4 slabs in flight: the strided
    serial march's rows bit for bit, every ray (off-grid, long, short and
    missing rays, partial entry slabs, the NaN ray, extents not whole
    bricks), contiguous and permuted density, and siddon_fwdgrad_plain to
    the fused kernel's tolerance."""
    rng = np.random.default_rng(100 + axis)
    vol, vol_f = _densities(rng, _BRICK_DIMS)
    rows = _fwd_rays(rng, _BRICK_DIMS, axis)
    plain = siddon_fwdgrad_plain(rows[:, :-1], vol, axis)
    serial = _bits(_run_twin(twin, True, rows, vol, axis))
    assert (plain == 0).all(0).any() and (plain[9] > 0).sum() > 80
    for variant in _LANES + _UNROLLED:
        got = _fused_siddon(ftwin, variant, rows, vol, axis)
        assert torch.equal(_bits(got), serial), _FUSED_VARIANTS[variant]
        assert torch.equal(_bits(_fused_siddon(ftwin, variant, rows, vol_f, axis)), serial)
        _assert_fused_close(got[:, :-1], plain, 9, f"(G, U) {_FUSED_VARIANTS[variant]}")


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_siddon_fused_g1_equals_strided_serial(twin, ftwin, axis):
    """G = 1 on the bricked copy is the strided serial trace_fwdgrad bit for
    bit, every ray (the NaN ray too), contiguous and permuted density."""
    rng = np.random.default_rng(110 + axis)
    vol, vol_f = _densities(rng, _BRICK_DIMS)
    rows = _fwd_rays(rng, _BRICK_DIMS, axis)
    ref = _bits(_run_twin(twin, True, rows, vol, axis))
    for v in (vol, vol_f):
        assert torch.equal(_bits(_fused_siddon(ftwin, 0, rows, v, axis)), ref)


_FUSED_H = pytest.mark.parametrize("h", [1.0, 4.0, 1.37, 0.26],
                                   ids=["h1", "h4", "h1.37", "h0.26"])


@_FUSED_H
@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_fused_lanes_match_plain(jtwin, ftwin, axis, mode, h):
    """The Joseph fused kernel's lanes on the bricked copy at G = 1, 2, 8 and
    32 and at the kernel's G with U = 1, 2 and 4 steps in flight, integer
    and fractional h: the strided serial march bit for bit (sum: the same
    order of sums; max: each lane's first maximum and the tree), the
    argmax exact against the plain version, and joseph_fwdgrad_plain to
    the fused kernel's tolerance."""
    rng = np.random.default_rng(120 + axis)
    vol, _ = _densities(rng, _BRICK_DIMS)
    rows = _fwd_rays(rng, _BRICK_DIMS, axis, quadrature="joseph", h=h)
    n = int(-(-_BRICK_DIMS[axis] // h))
    mip = mode == "max"
    plain, plain_arg = J.joseph_fwdgrad_plain(rows[:, :-1], vol, axis, h, n, mode)
    serial, serial_arg = _JosephTwin(jtwin, rows, vol, axis, h, n).fwdgrad(mip)
    assert (plain[7] > 0).sum() > 80
    for variant in _LANES + _UNROLLED:
        got, arg = _fused_joseph(ftwin, variant, mip, rows, vol, axis, h, n)
        assert torch.equal(_bits(got), _bits(serial)), _FUSED_VARIANTS[variant]
        if mip:
            assert torch.equal(arg[:-1], plain_arg) and torch.equal(arg, serial_arg)
        _assert_fused_close(got[:, :-1], plain, 7, f"(G, U) {_FUSED_VARIANTS[variant]}")


@pytest.mark.parametrize("h", [1.0, 1.37], ids=["h1", "h1.37"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_fused_g1_equals_strided_serial(jtwin, ftwin, axis, h):
    """G = 1 on the bricked copy is the strided serial trace_fwdgrad bit for
    bit, sum and max, every ray, contiguous and permuted density."""
    rng = np.random.default_rng(130 + axis)
    vol, vol_f = _densities(rng, _BRICK_DIMS)
    rows = _fwd_rays(rng, _BRICK_DIMS, axis, quadrature="joseph", h=h)
    n = int(-(-_BRICK_DIMS[axis] // h))
    for mip in (False, True):
        ref, ref_arg = _JosephTwin(jtwin, rows, vol, axis, h, n).fwdgrad(mip)
        for v in (vol, vol_f):
            got, arg = _fused_joseph(ftwin, 0, mip, rows, v, axis, h, n)
            assert torch.equal(_bits(got), _bits(ref))
            assert (arg is None) or torch.equal(arg, ref_arg)


@pytest.mark.parametrize("variant", [1, 2, 3], ids=["G2", "G8", "G32"])
def test_twin_joseph_fused_max_tie_takes_the_smaller_step(jtwin, ftwin, variant):
    """MIP ties across lanes: rays along axis 0 through a density whose
    planes are alike but for two equal brighter ones, p1 < p2, with p2 on a
    lower lane than p1; and through a density of identical planes, where
    every in-slab step ties. The combine must take the smaller step, as the
    serial first maximum does: the argmax exact against the plain version
    and the serial march, the rows bit for bit the serial march's."""
    G = _FUSED_VARIANTS[variant][0]
    dims = (84, 9, 7)
    rng = np.random.default_rng(140 + variant)
    plane = rng.uniform(0.2, 0.6, dims[1:])
    n_rays = 24
    y = rng.uniform(1.2, 6.8, n_rays)
    z = rng.uniform(1.2, 4.8, n_rays)
    # From x = -30, well before the volume, so every ray's step range starts
    # at 0 and step p is on lane p % G.
    src = torch.tensor(np.stack([np.full(n_rays, -30.0), y, z], 1)[:, None], dtype=torch.float32)
    tgt = torch.tensor(np.stack([np.full(n_rays, 120.0), y, z], 1)[:, None], dtype=torch.float32)
    rows = prep_rays(src, tgt, torch.ones((n_rays, 1, 1)), 0, dims, quadrature="joseph", h=1.0)
    p1 = G + G // 2  # lane G / 2
    p2 = p1 + G - 1  # lane G / 2 - 1
    bright = np.repeat(plane[None], dims[0], 0)
    bright[[p1, p2]] = 2.0 * plane
    flat = np.repeat(plane[None], dims[0], 0)
    for dens, want in ((bright, p1), (flat, 0)):
        vol = torch.tensor(dens, dtype=torch.float32)
        plain_arg = J.joseph_fwdgrad_plain(rows, vol, 0, 1.0, dims[0], "max")[1]
        serial, serial_arg = _JosephTwin(jtwin, rows, vol, 0, 1.0, dims[0]).fwdgrad(True)
        got, arg = _fused_joseph(ftwin, variant, True, rows, vol, 0, 1.0, dims[0])
        assert torch.equal(arg, plain_arg) and torch.equal(arg, serial_arg)
        assert (arg == want).all()
        assert torch.equal(_bits(got), _bits(serial))


def test_twin_fused_lanes_deterministic(ftwin):
    """Two runs of the lanes give the same bits, for both fused kernels at
    every G, in sum and (Joseph) max mode."""
    rng = np.random.default_rng(150)
    vol, _ = _densities(rng, _BRICK_DIMS)
    rows_s = _fwd_rays(rng, _BRICK_DIMS, 2)
    rows_j = _fwd_rays(rng, _BRICK_DIMS, 2, quadrature="joseph", h=1.37)
    n = int(-(-_BRICK_DIMS[2] // 1.37))
    for variant in _LANES:
        a = _fused_siddon(ftwin, variant, rows_s, vol, 2)
        assert torch.equal(_bits(a), _bits(_fused_siddon(ftwin, variant, rows_s, vol, 2)))
        for mip in (False, True):
            b, b_arg = _fused_joseph(ftwin, variant, mip, rows_j, vol, 2, 1.37, n)
            c, c_arg = _fused_joseph(ftwin, variant, mip, rows_j, vol, 2, 1.37, n)
            assert torch.equal(_bits(b), _bits(c))
            assert (b_arg is None) or torch.equal(b_arg, c_arg)
