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
// The channel scatter's warp order, as jt_bwd_vol_warp's: a ray whose
// cotangent is 0 in every channel skipped, then passes of 32 steps, each
// pass's adds (step_adds_ch_at) in path order and made last to first.
extern "C" void jt_bwd_vol_ch_warp(const float* rows, int64_t R, const float* g, float* grad,
                                   int64_t gs, int64_t gy, int64_t gz, int X, int Y, int Z,
                                   float h, int n, int blend, LAB_ARGS) {
  GradVolume gv{grad, gs, gy, gz, X, Y, Z};
  March m = mk(h, n, blend);
  LAB;
  for (int64_t r = 0; r < R; ++r) {
    bool any = false;
    for (int c = 0; c < C; ++c) any |= g[c * R + r] != 0.f;
    if (!any) continue;
    Ray ray = load_ray(rows, R, r);
    int lo, hi;
    step_range(ray, m, &lo, &hi);
    for (int base = lo; base < hi; base += 32) {
      int64_t s_off[kStepAdds * 32];
      float s_x[kStepAdds * 32];
      int total = 0;
      for (int lane = 0; lane < 32 && base + lane < hi; ++lane) {
        int64_t off[kStepAdds];
        float x[kStepAdds];
        unsigned mask = step_adds_ch_at(ray, gv, l, m, base + lane, C, g + r, R, off, x);
        for (int q = 0; q < kStepAdds; ++q)
          if (mask >> q & 1u) { s_off[total] = off[q]; s_x[total] = x[q]; ++total; }
      }
      for (int q = total - 1; q >= 0; --q) grad[s_off[q]] += s_x[q];
    }
  }
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
    so.jt_bwd_vol_ch_warp.argtypes = so.jt_bwd_vol_ch.argtypes
    for fn in (so.jt_fwd, so.jt_fwd_max, so.jt_fwdgrad, so.jt_bwd_rays, so.jt_bwd_vol,
               so.jt_bwd_vol_warp, so.jt_fwd_ch, so.jt_bwd_rays_ch, so.jt_bwd_vol_ch,
               so.jt_bwd_vol_ch_warp):
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

    def bwd_vol_ch(self, lab, g, warp=False):
        grad = torch.zeros(self.vol.shape)
        fn = self.so.jt_bwd_vol_ch_warp if warp else self.so.jt_bwd_vol_ch
        fn(self.rows.data_ptr(), self.R, g.data_ptr(), grad.data_ptr(), *_geom(grad, self.axis),
           *self.march, *self._lab(lab, g.shape[0]))
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


def _channel_case(rows, n_channels, seed):
    """(labels, g) of a channel case on ``_WARP_DIMS``: labels 0..4 held in
    another memory order than the density (at 3 channels labels 3 and 4
    drop), and a (C, R) cotangent that is 0 in every channel for every
    seventh ray."""
    rng = np.random.default_rng(seed)
    lab = torch.tensor(rng.integers(0, 5, _WARP_DIMS[::-1]), dtype=torch.int32)
    g = torch.tensor(rng.normal(size=(n_channels, rows.shape[1])), dtype=torch.float32)
    g[:, ::7] = 0.0
    return lab.permute(2, 1, 0).to(rows.device), g.to(rows.device)


_CHANNELS = pytest.mark.parametrize("n_channels", [5, 3])


@_CHANNELS
@_WARP_H
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_warp_channel_scatter_matches_plain(jtwin, axis, h, n_channels):
    """step_adds_ch_at in the channel scatter's warp order (rays of a zero
    cotangent skipped, passes of 32 steps, each pass's adds in path order,
    made last to first) against joseph_bwd_vol_ch_plain: long, short and
    missing rays, integer, fractional and oversampling strides, labels
    that drop."""
    vol, rows, _, n = _joseph_warp_scene(axis, h, 70 + axis)
    lab, g = _channel_case(rows, n_channels, 170 + axis)
    ref = J.joseph_bwd_vol_ch_plain(rows, g, lab, _WARP_DIMS, axis, h, n)
    got = _JosephTwin(jtwin, rows, vol, axis, h, n).bwd_vol_ch(lab, g, warp=True)
    assert torch.count_nonzero(ref) > 0
    np.testing.assert_allclose(got, ref, atol=1e-5 * ref.abs().max().item())


@pytest.mark.gpu
@_CHANNELS
@_WARP_H
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cuda_joseph_channel_backwards_mixed_rays(axis, h, n_channels):
    """On a card, on the mixed rays: joseph_bwd_rays_ch (G lanes a ray on
    the bricked copies of the density and the labelmap, each made once and
    then cached) equal to its plain version and the same on a repeated
    launch; joseph_bwd_vol_ch (one warp per ray) to 1e-5 * max (float
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vol, rows, _, n = _joseph_warp_scene(axis, h, 70 + axis, "cuda")
    lab, g = _channel_case(rows, n_channels, 170 + axis)
    clear_cache()
    copies = brick_density.launches
    got = J.joseph_bwd_rays_ch(rows, vol, lab, axis, h, n, g)
    again = J.joseph_bwd_rays_ch(rows, vol, lab, axis, h, n, g)
    ref = J.joseph_bwd_rays_ch_plain(rows, vol, lab, axis, h, n, g)
    got_v = J.joseph_bwd_vol_ch(rows, g, lab, vol.shape, axis, h, n)
    ref_v = J.joseph_bwd_vol_ch_plain(rows, g, lab, vol.shape, axis, h, n)
    torch.cuda.synchronize()
    assert brick_density.launches == copies + 2
    assert torch.equal(_bits(got), _bits(again))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert got_v.is_contiguous() and torch.count_nonzero(ref_v) > 0
    torch.testing.assert_close(got_v, ref_v, rtol=0, atol=1e-5 * ref_v.abs().max().item())


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
#include <string.h>
#include <type_traits>
#include <vector>
#include "joseph.cuh"
#include "siddon.cuh"
// The copy's arguments, its elements of type E (float, or brick::bf16 in
// the *_bf16 entry points at the end).
#define COPY_ARGS(E) const E* bvol, int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z
#define COPY bvol, axis, bs_s, bs_y, bs_z, X, Y, Z
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
// takes the kernels' own count (kFwdSlabs; kFwdStepsOf for the copy's
// element T, kFwdBlendSteps for the float32 copy in blend mode, where
// joseph_fwd runs trace_fwd_raw).
template <class F>
static void each_unroll(int unroll, F f) {
  switch (unroll) {
    case 1: f(std::integral_constant<int, 1>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 8: f(std::integral_constant<int, 8>()); break;
    default: f(std::integral_constant<int, 0>()); break;
  }
}
template <class T>
static void bt_siddon_t(int unroll, const float* rows, int64_t R, COPY_ARGS(T), float* out) {
  with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    each_unroll(unroll, [&](auto u) {
      constexpr int U = decltype(u)::value ? decltype(u)::value : siddon::kFwdSlabs;
      for (int64_t r = 0; r < R; ++r)
        out[r] = siddon::trace_fwd<U>(siddon::load_ray(rows, R, r), v);
    });
  });
}
template <class T>
static void bt_joseph_t(int unroll, const float* rows, int64_t R, COPY_ARGS(T), float h, int n,
                          int blend, float* out) {
  joseph::March m;
  m.h = h;
  m.n_steps = n;
  m.blend = blend != 0;
  with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    each_unroll(unroll, [&](auto u) {
      constexpr int N = decltype(u)::value;
      if constexpr (std::is_same<T, float>::value) {
        if (m.blend) {  // joseph_fwd_kernel's Blend instantiation
          constexpr int U = N ? N : joseph::kFwdBlendSteps;
          for (int64_t r = 0; r < R; ++r)
            out[r] = joseph::trace_fwd_raw<U>(joseph::load_ray(rows, R, r), v, m);
          return;
        }
      }
      constexpr int U = N ? N : joseph::kFwdStepsOf<T>;
      for (int64_t r = 0; r < R; ++r)
        out[r] = joseph::trace_fwd<U>(joseph::load_ray(rows, R, r), v, m);
    });
  });
}
// f(G, U) of a variant of the MIP and channel forwards' lanes: G lanes a
// ray and U slabs (steps) in flight a lane, 0 taking the kernel's own
// (kMaxLanes and kMaxSlabs or kMaxSteps, kFwdChLanesOf<T> and
// kFwdChStepsOf<T>);
// _FWD_VARIANTS in the tests lists them in this order. A bf16 copy (T not
// float) takes the kernel's own only.
template <int N>
using IC = std::integral_constant<int, N>;
template <class T, class F>
static void with_lanes(int variant, F f) {
  if constexpr (!std::is_same<T, float>::value) {
    f(IC<0>(), IC<0>());
    return;
  }
  switch (variant) {
    case 0: f(IC<1>(), IC<1>()); break;
    case 1: f(IC<1>(), IC<2>()); break;
    case 2: f(IC<1>(), IC<4>()); break;
    case 3: f(IC<2>(), IC<0>()); break;
    case 4: f(IC<8>(), IC<0>()); break;
    case 5: f(IC<32>(), IC<0>()); break;
    case 6: f(IC<0>(), IC<1>()); break;
    case 7: f(IC<0>(), IC<2>()); break;
    case 8: f(IC<0>(), IC<4>()); break;
    default: f(IC<0>(), IC<0>()); break;
  }
}
// f(G, U) of a variant of joseph_fwd_ch's lanes: with_lanes<T>'s, or in the
// build with CH_VARIANTS (the channel entry points alone, both copies at
// every variant) ch_variant's: G = 4, 8, 16 at U = 1, 2, 4 and the
// kernel's own.
template <class T, class F>
static void with_ch_lanes(int variant, F f) {
#if defined(CH_VARIANTS)
  ch_variant(variant, f);
#else
  with_lanes<T>(variant, f);
#endif
}
// One ray's first maximum as the MIP forwards' lanes run it (fwd_max_lanes),
// lane after lane: each of G lanes the first maximum of its slabs (steps)
// lo + j, lo + j + G, ..., U at a time (max_u(s0, best, arg): max_slabs or
// max_steps from s0, G apart), then the lanes' tree (combine_max_lanes).
// Returns whether the lanes still differ after the tree.
template <int G, int U, class MaxU>
static bool lanes_max(int lo, int hi, MaxU max_u, float* val, int* arg) {
  float best[G][1];
  int best_arg[G];
  for (int j = 0; j < G; ++j) {
    best[j][0] = 0.f;
    best_arg[j] = -1;
    for (int s0 = lo + j; s0 < hi; s0 += G * U) max_u(s0, &best[j][0], &best_arg[j]);
  }
  lanes::combine_max_lanes<G, 1, 0>(best, best_arg);
  bool differ = false;
  for (int j = 1; j < G; ++j)
    differ |= memcmp(best[j], best[0], sizeof(best[0])) != 0 || best_arg[j] != best_arg[0];
  *val = best[0][0];
  *arg = best_arg[0];
  return differ;
}
// siddon_fwd_max on the bricked copy as its lanes run it (max_slabs in
// lanes_max). Returns the number of rays whose lanes still differ after the
// tree.
template <class T>
static int bt_siddon_max_t(int variant, const float* rows, int64_t R, COPY_ARGS(T), float* out,
                             int* arg) {
  int bad = 0;
  with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    with_lanes<T>(variant, [&](auto g, auto u) {
      constexpr int G = decltype(g)::value ? decltype(g)::value : siddon::kMaxLanes;
      constexpr int U = decltype(u)::value ? decltype(u)::value : siddon::kMaxSlabs;
      for (int64_t r = 0; r < R; ++r) {
        siddon::Ray ray = siddon::load_ray(rows, R, r);
        int lo, hi;
        siddon::slab_range(ray, X, &lo, &hi);
        bad += lanes_max<G, U>(lo, hi, [&](int s0, float* best, int* best_arg) {
          siddon::max_slabs<U>(ray, v, s0, G, hi, best, best_arg);
        }, out + r, arg + r);
      }
    });
  });
  return bad;
}
// joseph_fwd_max on the bricked copy as its lanes run it (max_steps in
// lanes_max). Returns the number of rays whose lanes still differ after the
// tree.
template <class T>
static int bt_joseph_max_t(int variant, const float* rows, int64_t R, COPY_ARGS(T), float h,
                             int n, int blend, float* out, int* arg) {
  joseph::March m;
  m.h = h;
  m.n_steps = n;
  m.blend = blend != 0;
  int bad = 0;
  with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    with_lanes<T>(variant, [&](auto g, auto u) {
      constexpr int G = decltype(g)::value ? decltype(g)::value : joseph::kMaxLanes;
      constexpr int U = decltype(u)::value ? decltype(u)::value : joseph::kMaxSteps;
      for (int64_t r = 0; r < R; ++r) {
        joseph::Ray ray = joseph::load_ray(rows, R, r);
        int lo, hi;
        joseph::step_range(ray, m, &lo, &hi);
        bad += lanes_max<G, U>(lo, hi, [&](int p0, float* best, int* best_p) {
          joseph::max_steps<U>(ray, v, m, p0, G, hi, best, best_p);
        }, out + r, arg + r);
      }
    });
  });
  return bad;
}
// joseph_fwd_ch on the bricked copies of the density and the labelmap
// (blab, sharing the density copy's arguments) as its lanes run it
// (fwd_ch_lanes), lane after lane: passes of G * U steps from lo, lane j
// taking steps base + j, base + j + G, ... (channel_samples), each pass's
// samples added in step order to the ray's sums (ChannelSums); the rays
// in blocks of kBlock whose sums share one [channel][ray] array, the
// channels in tiles of `tile` (0: all C in one), each tile's sums copied
// to the ray's column of out (C, R).
template <class T>
static void bt_joseph_ch_t(int variant, int tile, const float* rows, int64_t R, COPY_ARGS(T),
                             const float* blab, float h, int n, int blend, int C, float* out) {
  constexpr int kBlock = 3;
  joseph::March m;
  m.h = h;
  m.n_steps = n;
  m.blend = blend != 0;
  if (tile <= 0) tile = C;
  std::vector<float> sums((size_t)tile * kBlock, -1.f);
  with_axis(axis, [&](auto a) {
    constexpr int A = decltype(a)::value;
    auto v = brick::make_volume<A>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    joseph::BrickLabels<A> l{brick::make_volume<A>(blab, bs_s, bs_y, bs_z, X, Y, Z)};
    with_ch_lanes<T>(variant, [&](auto g, auto u) {
      constexpr int G = decltype(g)::value ? decltype(g)::value : joseph::kFwdChLanesOf<T>;
      constexpr int U = decltype(u)::value ? decltype(u)::value : joseph::kFwdChStepsOf<T>;
      for (int64_t r = 0; r < R; ++r) {
        joseph::Ray ray = joseph::load_ray(rows, R, r);
        int lo, hi;
        joseph::step_range(ray, m, &lo, &hi);
        float* mine = sums.data() + r % kBlock;
        for (int c0 = 0; c0 < C; c0 += tile) {
          int width = tile < C - c0 ? tile : C - c0;
          joseph::ChannelSums cs = joseph::channel_sums(mine, kBlock, c0, width);
          for (int base = lo; base < hi; base += G * U) {
            int c[G][U];
            float x[G][U];
            for (int j = 0; j < G; ++j)
              joseph::channel_samples<U>(ray, v, l, m, C, base + j, G, hi, c[j], x[j]);
            for (int k = 0; k < U; ++k)
              for (int j = 0; j < G; ++j) joseph::add_sample(cs, c[j][k], x[j][k]);
          }
          joseph::flush(cs);
          for (int k = 0; k < width; ++k) out[(c0 + k) * R + r] = mine[k * kBlock];
        }
      }
    });
  });
}
// The C entry points: each function above on a float32 copy (every
// variant) and, as *_bf16, on a bf16 copy (the forwards at every unroll,
// the lanes at the kernels' own variant); with CH_VARIANTS the channel
// lanes alone (CH_ENTRY), on both copies at every variant.
#define ENTRIES(S, E)                                                                         \
  extern "C" void bt_siddon##S(int unroll, const float* rows, int64_t R, COPY_ARGS(E),       \
                               float* out) {                                                  \
    bt_siddon_t(unroll, rows, R, COPY, out);                                                  \
  }                                                                                           \
  extern "C" void bt_joseph##S(int unroll, const float* rows, int64_t R, COPY_ARGS(E),       \
                               float h, int n, int blend, float* out) {                       \
    bt_joseph_t(unroll, rows, R, COPY, h, n, blend, out);                                     \
  }                                                                                           \
  extern "C" int bt_siddon_max##S(int variant, const float* rows, int64_t R, COPY_ARGS(E),   \
                                  float* out, int* arg) {                                     \
    return bt_siddon_max_t(variant, rows, R, COPY, out, arg);                                 \
  }                                                                                           \
  extern "C" int bt_joseph_max##S(int variant, const float* rows, int64_t R, COPY_ARGS(E),   \
                                  float h, int n, int blend, float* out, int* arg) {          \
    return bt_joseph_max_t(variant, rows, R, COPY, h, n, blend, out, arg);                    \
  }                                                                                           \
  CH_ENTRY(S, E)
#define CH_ENTRY(S, E)                                                                        \
  extern "C" void bt_joseph_ch##S(int variant, int tile, const float* rows, int64_t R,       \
                                  COPY_ARGS(E), const float* blab, float h, int n, int blend, \
                                  int C, float* out) {                                        \
    bt_joseph_ch_t(variant, tile, rows, R, COPY, blab, h, n, blend, C, out);                  \
  }
#if defined(CH_VARIANTS)
CH_ENTRY(, float)
CH_ENTRY(_bf16, brick::bf16)
#else
ENTRIES(, float)
#ifdef BF16_ENTRIES  // the kernels' own brick shape's build only
ENTRIES(_bf16, brick::bf16)
#endif
#endif
"""

_UNROLLS = (0, 1, 2, 4, 8)  # 0: the kernels' own count
# (G, U) of each variant of the MIP and channel forwards' lanes (None: the
# kernel's own), in the twin's order (with_lanes): one thread per ray at
# U = 1, 2, 4, G = 2, 8, 32 lanes, the kernel's G at U = 1, 2, 4, the kernel.
_FWD_VARIANTS = ((1, 1), (1, 2), (1, 4), (2, None), (8, None), (32, None),
                 (None, 1), (None, 2), (None, 4), (None, None))


@pytest.fixture(scope="module")
def btwin(tmp_path_factory):
    """The twin of the bricked trace_fwd for a brick shape: brick.cuh's
    compile-time shape set with -D, one build per shape; the bf16 copy's
    entry points in the kernels' own shape's build only."""
    built = {}

    def get(shape):
        if shape not in built:
            logs = [b.bit_length() - 1 for b in shape]
            own = shape == brick.BRICK
            so = _build_twin(tmp_path_factory, "btwin", _BRICK_TWIN_SRC,
                             [f"BRICK_L{d}={logs[d]}" for d in range(3)]
                             + (["BF16_ENTRIES"] if own else []))
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            bvol = [ptr] + [i32] * 7
            so.bt_siddon.argtypes = [i32, ptr, i64] + bvol + [ptr]
            so.bt_joseph.argtypes = [i32, ptr, i64] + bvol + [ctypes.c_float, i32, i32, ptr]
            so.bt_siddon_max.argtypes = [i32, ptr, i64] + bvol + [ptr, ptr]
            so.bt_joseph_max.argtypes = [i32, ptr, i64] + bvol + [ctypes.c_float, i32, i32,
                                                                  ptr, ptr]
            so.bt_joseph_ch.argtypes = [i32, i32, ptr, i64] + bvol + [ptr, ctypes.c_float, i32,
                                                                      i32, i32, ptr]
            names = ("bt_siddon", "bt_joseph", "bt_siddon_max", "bt_joseph_max", "bt_joseph_ch")
            for fn in names if own else ():  # the bf16 copy's entry points: the same arguments
                getattr(so, f"{fn}_bf16").argtypes = getattr(so, fn).argtypes
            for fn in names:
                for suffix in ("", "_bf16") if own else ("",):
                    getattr(so, fn + suffix).restype = i32 if fn.endswith("_max") else None
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
@pytest.mark.parametrize("h", [1.0, 4.0, 1.37, 0.6, 0.26, 511 / 499, 1.024],
                         ids=["h1", "h4", "h1.37", "h0.6", "h0.26", "h511_499", "h1.024"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_bricked_equals_strided(jtwin, btwin, axis, h, brick_shape):
    """joseph_fwd's march on the bricked copy (at fractional h trace_fwd_raw,
    its windows loaded raw, then lerped), at every unroll, equals the
    strided serial trace_fwd (window's lerp as each load lands) bit for bit,
    at integer h and at fractional h (whose last steps lerp toward plane X,
    which reads 0; 511/499 is the trilinear march's stride on 512 planes at
    n_points 500), and the plain version to 1e-6 * max on the finite rays."""
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


def _brick_any(t, brick_shape):
    """The bricked copy of a density, or of an int32 labelmap's bits, in
    bricks of ``brick_shape``."""
    if brick_shape == brick.BRICK:
        return brick_density(t)
    return _brick_copy(t.view(torch.float32) if t.dtype == torch.int32 else t, brick_shape)


def _bricked_max(btwin, rows, vol, axis, variant, brick_shape=brick.BRICK):
    """The twin's siddon_fwd_max lanes (``_FWD_VARIANTS[variant]``) on
    ``vol``'s bricked copy: (value, argmax)."""
    rows = rows.contiguous()
    R = rows.shape[1]
    bv = _brick_any(vol, brick_shape)
    val = torch.full((R,), float("nan"))
    arg = torch.full((R,), -2, dtype=torch.int32)
    bad = btwin(brick_shape).bt_siddon_max(variant, rows.data_ptr(), R, bv.data.data_ptr(),
                                           *bv.args(axis), val.data_ptr(), arg.data_ptr())
    assert bad == 0, f"{bad} rays' lanes hold different maxima after the tree"
    return val, arg


def _bricked_ch(btwin, rows, vol, lab, axis, h, n, C, variant, tile, brick_shape):
    """The twin's joseph_fwd_ch lanes (``_FWD_VARIANTS[variant]``, channels
    in tiles of ``tile``, 0: all) on the bricked copies of ``vol`` and the
    labelmap ``lab``: (C, R)."""
    rows = rows.contiguous()
    R = rows.shape[1]
    bv, bl = _brick_any(vol, brick_shape), _brick_any(lab, brick_shape)
    out = torch.full((C, R), float("nan"))
    btwin(brick_shape).bt_joseph_ch(variant, tile, rows.data_ptr(), R, bv.data.data_ptr(),
                                    *bv.args(axis), bl.data.data_ptr(), h, n,
                                    int(J.is_blend(h)), C, out.data_ptr())
    return out


@_BRICKS
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_siddon_max_bricked_equals_strided(twin, btwin, axis, brick_shape):
    """siddon_fwd_max's lanes on the bricked copy (max_slabs and the tree),
    one thread per ray at U = 1, 2, 4 slabs in flight, at G = 2, 8, 32 lanes
    a ray, at the kernel's G with U = 1, 2, 4 and at the kernel's own: the
    strided serial trace_fwd_max bit for bit, value and argmax (contiguous
    and permuted density, extents not whole bricks, partial entry slabs,
    rays that miss and keep the argmax -1, the NaN ray), and the plain
    version exactly on the finite rays."""
    rng = np.random.default_rng(200 + axis)
    vol, vol_f = _densities(rng, _BRICK_DIMS)
    rows = _fwd_rays(rng, _BRICK_DIMS, axis)
    ref_val, ref_arg = _run_twin_fwd_max(twin, rows, vol, axis)
    assert ref_arg[-1] == -1 and (ref_arg[:-1] == -1).any() and (ref_arg >= 0).sum() > 80
    for variant, gu in enumerate(_FWD_VARIANTS):
        for v in (vol, vol_f):
            val, arg = _bricked_max(btwin, rows, v, axis, variant, brick_shape)
            assert torch.equal(arg, ref_arg), (gu, v.is_contiguous())
            assert torch.equal(_bits(val), _bits(ref_val)), (gu, v.is_contiguous())
    plain_val, plain_arg = siddon_fwd_max_plain(rows[:, :-1], vol, axis)
    assert torch.equal(ref_arg[:-1], plain_arg)
    torch.testing.assert_close(ref_val[:-1], plain_val, rtol=0, atol=0)


@pytest.mark.parametrize("bright", [False, True], ids=["flat", "two_bright_planes"])
def test_twin_siddon_max_tie_keeps_the_first_maximum(twin, btwin, bright):
    """Exact ties: rays along axis 0 with a = 1/64, b = 1/4 and transverse
    slopes 0, so every slab's alphas are exact in float32 and each slab is
    one segment (the third) of length 1/64. Through identical planes every
    slab ties, and the first (slab 0: code 2) must win; with two equal
    brighter planes p1 < p2, p1 (code 4 p1 + 2), though at 8 lanes p2 lies
    on a lower lane than p1. Every variant of the lanes keeps it, as the
    strided serial march and the plain version do."""
    dims, n = (40, 9, 7), 24
    rng = np.random.default_rng(210)
    plane = rng.uniform(0.2, 0.6, dims[1:])
    dens = np.repeat(plane[None], dims[0], 0)
    p1, p2 = 5, 11  # lanes 5 and 3 of 8; in different groups of 2 and of 4 slabs
    if bright:
        dens[[p1, p2]] = 2.0 * plane
    vol = torch.tensor(dens, dtype=torch.float32)
    rows = torch.zeros((9, n))
    rows[0], rows[1], rows[6], rows[8] = 1 / 64, 0.25, 1.0, 1.0  # a, b, w, amax
    rows[2] = torch.tensor(rng.uniform(0.6, 7.4, n), dtype=torch.float32)  # gy, dy = 0
    rows[4] = torch.tensor(rng.uniform(0.6, 5.4, n), dtype=torch.float32)  # gz, dz = 0
    want = torch.full((n,), 4 * p1 + 2 if bright else 2, dtype=torch.int32)
    ref_val, ref_arg = _run_twin_fwd_max(twin, rows, vol, 0)
    plain_val, plain_arg = siddon_fwd_max_plain(rows, vol, 0)
    assert torch.equal(ref_arg, want) and torch.equal(plain_arg, want)
    torch.testing.assert_close(ref_val, plain_val, rtol=0, atol=0)
    for variant, gu in enumerate(_FWD_VARIANTS):
        val, arg = _bricked_max(btwin, rows, vol, 0, variant)
        assert torch.equal(arg, want) and torch.equal(_bits(val), _bits(ref_val)), gu


def _bricked_jmax(btwin, rows, vol, axis, h, n, variant, brick_shape=brick.BRICK):
    """The twin's joseph_fwd_max lanes (``_FWD_VARIANTS[variant]``) on
    ``vol``'s bricked copy: (value, argmax step)."""
    rows = rows.contiguous()
    R = rows.shape[1]
    bv = _brick_any(vol, brick_shape)
    val = torch.full((R,), float("nan"))
    arg = torch.full((R,), -2, dtype=torch.int32)
    bad = btwin(brick_shape).bt_joseph_max(variant, rows.data_ptr(), R, bv.data.data_ptr(),
                                           *bv.args(axis), h, n, int(J.is_blend(h)),
                                           val.data_ptr(), arg.data_ptr())
    assert bad == 0, f"{bad} rays' lanes hold different maxima after the tree"
    return val, arg


_STRIDES = pytest.mark.parametrize("h", [1.0, 4.0, 1.37, 0.6, 0.26],
                                   ids=["h1", "h4", "h1.37", "h0.6", "h0.26"])


@_STRIDES
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_max_bricked_equals_strided(jtwin, btwin, axis, h):
    """joseph_fwd_max's lanes on the bricked copy (max_steps and the tree),
    one thread per ray at U = 1, 2, 4 steps in flight, at G = 2, 8, 32 lanes
    a ray, at the kernel's G with U = 1, 2, 4 and at the kernel's own, on
    4x4x4 bricks (the package's) and 2x8x1: the strided serial
    trace_fwd_max bit for bit, value and argmax step, at integer and
    fractional h (contiguous and permuted density, extents not whole
    bricks, partial entry steps, rays that miss and keep the argmax -1, the
    NaN ray), and the plain version exactly on the finite rays."""
    rng = np.random.default_rng(230 + axis)
    vol, vol_f = _densities(rng, _BRICK_DIMS)
    rows = _fwd_rays(rng, _BRICK_DIMS, axis, quadrature="joseph", h=h)
    n = int(-(-_BRICK_DIMS[axis] // h))
    ref_val, ref_arg = _JosephTwin(jtwin, rows, vol, axis, h, n).fwd_max()
    assert ref_arg[-1] == -1 and (ref_arg[:-1] == -1).any() and (ref_arg >= 0).sum() > 80
    for brick_shape in ((4, 4, 4), (2, 8, 1)):
        for variant, gu in enumerate(_FWD_VARIANTS):
            for v in (vol, vol_f):
                val, arg = _bricked_jmax(btwin, rows, v, axis, h, n, variant, brick_shape)
                assert torch.equal(arg, ref_arg), (brick_shape, gu, v.is_contiguous())
                assert torch.equal(_bits(val), _bits(ref_val)), \
                    (brick_shape, gu, v.is_contiguous())
    plain_val, plain_arg = J.joseph_fwd_max_plain(rows[:, :-1], vol, axis, h, n)
    assert torch.equal(ref_arg[:-1], plain_arg)
    torch.testing.assert_close(ref_val[:-1], plain_val, rtol=0, atol=0)


_TIE_PLANES = (5, 11)  # lanes 5 and 3 of 8; in different groups of 2 and of 4 steps


def _joseph_tie_scene(case):
    """(rows, density, want) of the Joseph MIP ties: 23 rays along axis 0
    of a 40x9x7 density with a = 1/64, b = 1/4, sc = 1, [amin, amax] = [0,
    1] and transverse slopes 0, so every one of the 40 steps (h = 1) is in
    the slab and samples its plane at the ray's (gy, gz) with the same
    weights. ``flat``: identical planes, every step ties, step 0 wins;
    ``two_bright_planes``: the planes _TIE_PLANES twice as bright, the
    first of them wins; ``zero``: no sample beats 0, the argmax is -1."""
    dims, n = (40, 9, 7), 23
    rng = np.random.default_rng(240)
    plane = rng.uniform(0.2, 0.6, dims[1:])
    dens = np.repeat(plane[None], dims[0], 0)
    if case == "two_bright_planes":
        dens[list(_TIE_PLANES)] = 2.0 * plane
    elif case == "zero":
        dens[:] = 0.0
    rows = torch.zeros((9, n))
    rows[0], rows[1], rows[6], rows[8] = 1 / 64, 0.25, 1.0, 1.0  # a, b, sc, amax
    rows[2] = torch.tensor(rng.uniform(0.6, 7.4, n), dtype=torch.float32)  # gy, dy = 0
    rows[4] = torch.tensor(rng.uniform(0.6, 5.4, n), dtype=torch.float32)  # gz, dz = 0
    want = {"flat": 0, "two_bright_planes": _TIE_PLANES[0], "zero": -1}[case]
    return rows, torch.tensor(dens, dtype=torch.float32), want


@pytest.mark.parametrize("case", ["flat", "two_bright_planes", "zero"])
def test_twin_joseph_max_tie_keeps_the_first_maximum(jtwin, btwin, case):
    """Exact ties in joseph_fwd_max (``_joseph_tie_scene``): the first of
    equal maxima wins, though at 8 lanes the second bright plane lies on a
    lower lane than the first, and a ray whose samples are all 0 keeps the
    argmax -1 and the value 0. Every variant of the lanes keeps it, as the
    strided serial march and the plain version do."""
    rows, vol, want = _joseph_tie_scene(case)
    ref_val, ref_arg = _JosephTwin(jtwin, rows, vol, 0, 1.0, 40).fwd_max()
    plain_val, plain_arg = J.joseph_fwd_max_plain(rows, vol, 0, 1.0, 40)
    assert (ref_arg == want).all() and torch.equal(plain_arg, ref_arg)
    torch.testing.assert_close(ref_val, plain_val, rtol=0, atol=0)
    assert bool((ref_val == 0).all()) == (case == "zero")
    for variant, gu in enumerate(_FWD_VARIANTS):
        val, arg = _bricked_jmax(btwin, rows, vol, 0, 1.0, 40, variant)
        assert (arg == want).all() and torch.equal(_bits(val), _bits(ref_val)), gu


@pytest.mark.parametrize("n_channels", [1, 3, 7])
@pytest.mark.parametrize("h", [1.0, 0.5, 1.37], ids=["h1", "h0.5", "h1.37"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_channels_bricked_equal_strided(jtwin, btwin, axis, h, n_channels):
    """joseph_fwd_ch's lanes (channel_samples and the ray's ChannelSums) on
    the bricked copies of the density and the labelmap, at every variant of
    _FWD_VARIANTS, with all C channels in one tile and in tiles of 2 and of
    1, on 4x4x4 bricks (the package's) and 2x8x1: the strided serial
    trace_fwd_ch bit for bit, every ray (off-grid, long, short and missing
    rays, partial entry steps, the NaN ray, extents not whole bricks; at
    h = 0.5 a plane-pair tie every other step), contiguous and permuted
    density, labels -1..C (-1 and C drop) held in another memory order, and
    joseph_fwd_ch_plain exactly on the finite rays."""
    rng = np.random.default_rng(220 + axis)
    vol, vol_f = _densities(rng, _BRICK_DIMS)
    lab = torch.tensor(rng.integers(-1, n_channels + 1, _BRICK_DIMS[::-1]),
                       dtype=torch.int32).permute(2, 1, 0)
    rows = _fwd_rays(rng, _BRICK_DIMS, axis, quadrature="joseph", h=h)
    n = int(-(-_BRICK_DIMS[axis] // h))
    ref = _JosephTwin(jtwin, rows, vol, axis, h, n).fwd_ch(lab, n_channels)
    plain = J.joseph_fwd_ch_plain(rows[:, :-1], vol, lab, axis, h, n, n_channels)
    torch.testing.assert_close(ref[:, :-1], plain, rtol=0, atol=0)
    assert (ref[:, -1] == 0).all() and (ref > 0).sum(0).ge(min(n_channels, 2)).sum() > 50
    for brick_shape in ((4, 4, 4), (2, 8, 1)):
        for variant, gu in enumerate(_FWD_VARIANTS):
            for tile in (0, 2, 1):
                for v in (vol, vol_f):
                    got = _bricked_ch(btwin, rows, v, lab, axis, h, n, n_channels, variant, tile,
                                      brick_shape)
                    assert torch.equal(_bits(got), _bits(ref)), \
                        (brick_shape, gu, tile, v.is_contiguous())


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


@pytest.mark.parametrize("dims", [(21, 23, 13), (5, 1, 9), (72, 70, 68)])
def test_brick_labels_keep_their_bits(dims):
    """An int32 labelmap, contiguous or permuted, is bricked as its labels'
    bits (negative labels too): the copy seen as int32 holds every label at
    the index gather's place, 0 in the padding, with the density copy's
    shape and arguments."""
    rng = np.random.default_rng(sum(dims) + 1)
    bs = brick.BRICK
    lab = torch.tensor(rng.integers(-3, 300, dims[::-1]), dtype=torch.int32).permute(2, 1, 0)
    idx = torch.meshgrid(*(torch.arange(e) for e in dims), indexing="ij")
    at = tuple([i // b for i, b in zip(idx, bs)] + [i % b for i, b in zip(idx, bs)])
    dens = brick_density(torch.zeros(dims))
    for t in (lab, lab.contiguous()):
        bl = brick_density(t)
        assert bl.data.dtype == torch.float32 and bl.shape == dims
        assert bl.data.shape == dens.data.shape and bl.args(1) == dens.args(1)
        bits = bl.data.view(torch.int32)
        assert torch.equal(bits[at], lab)
        assert torch.count_nonzero(bits) == torch.count_nonzero(lab)


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


# The copy's plan (csrc/brick.cuh): brick_copy as its blocks run it, one
# chunk of a column at a time, with the header's dispatch, addressing and
# (on the general path) each thread's walk over the chunk's elements. The
# tile starts as a pattern no density holds here, so a word read but never
# filled shows; the twin also checks that every element read is a voxel of
# the density, every tile word of the chunk's rows inside it filled exactly
# once, and what the packed path's 16-byte accesses need: each span's start
# 16-byte aligned, its 16-byte words landing whole and aligned in the tile.
_COPY_TWIN_SRC = r"""
#include <string.h>
#include <vector>
#include "brick.cuh"

static void put(float x, float* out) { memcpy(out, &x, sizeof x); }
static void put(float x, brick::bf16* out) { *out = brick::to_bf16(x); }

// Chunk c of column (b0, b1) into the tile as the kernel fills it; false
// where a read or a tile word breaks what the kernel needs.
static bool fill(const float* src, const brick::CopyPlan& p, int b0, int b1, int c, int len,
                 std::vector<float>& tile) {
  std::vector<int> hits(tile.size(), 0);
  if (p.packed) {
    for (int e0 = 0; e0 < (1 << brick::kL0); ++e0) {
      int n = brick::span_length(p, b0, b1, e0);
      const float* span = src + brick::span_offset(p, b0, b1, e0);
      if (n > 0 && (uintptr_t)span % 16 != 0) return false;
      for (int j = 0; j < n; ++j) {
        // each element read is a voxel of the density
        if ((b0 << brick::kL0) + e0 >= p.X0 || (b1 << brick::kL1) + j / p.X2 >= p.X1)
          return false;
        int t = brick::span_target(p, e0, j);
        if (t < 0 || t >= (int)tile.size() || hits[t]++) return false;
        // a 16-byte word of the span lands whole at a 16-byte word of the tile
        if (j < (n & ~3) && t - brick::span_target(p, e0, j & ~3) != (j & 3)) return false;
        if (j % 4 == 0 && j < (n & ~3) && t % 4 != 0) return false;
        memcpy(&tile[t], span + j, sizeof(float));
      }
    }
  } else {
    int steps = (brick::kColumnRows * len + brick::kCopyThreads - 1) / brick::kCopyThreads;
    for (int thread = 0; thread < brick::kCopyThreads; ++thread) {
      brick::Walk w = brick::walk_start(p, len, thread, brick::kCopyThreads);
      for (int k = 0; k < steps; ++k, brick::walk_next(w)) {
        int r, z;
        if (!brick::walk_at(p, w, &r, &z) || !brick::row_inside(p, b0, b1, r)) continue;
        if (r < 0 || r >= brick::kColumnRows || z < 0 || z >= len) return false;
        int t = r * p.pitch + z;
        if (hits[t]++) return false;
        memcpy(&tile[t], src + brick::element_offset(p, b0, b1, r, c * p.chunk + z),
               sizeof(float));
      }
    }
  }
  for (int r = 0; r < brick::kColumnRows; ++r)
    for (int z = 0; z < len; ++z)
      if (brick::row_inside(p, b0, b1, r) && hits[r * p.pitch + z] != 1) return false;
  return true;
}

// 1: the packed path, 0: the general path (always, where general != 0);
// -1 where the plan breaks what the kernel needs.
template <class T>
static int copy(const float* src, int64_t s0, int64_t s1, int64_t s2, int X0, int X1, int X2,
                T* dst, int general) {
  brick::CopyPlan p = brick::make_copy_plan((uint64_t)(uintptr_t)src, s0, s1, s2, X0, X1, X2);
  if (general) p.packed = false;
  if (p.packed && p.chunks != 1) return -1;
  const float unfilled = 12345.678f;
  for (int b0 = 0; b0 < p.n0; ++b0)
    for (int b1 = 0; b1 < p.n1; ++b1)
      for (int c = 0; c < p.chunks; ++c) {
        int len = brick::chunk_length(p, c);
        std::vector<float> tile(brick::kColumnRows * p.pitch, unfilled);
        if (!fill(src, p, b0, b1, c, len, tile)) return -1;
        T* out = dst + brick::run_offset(p, b0, b1, c);
        int n = ((len + (1 << brick::kL2) - 1) >> brick::kL2)
                << (brick::kL0 + brick::kL1 + brick::kL2);
        for (int o = 0; o < n; ++o) {
          int i = brick::copy_source(p, b0, b1, len, o);
          put(i < 0 ? 0.f : tile[i], out + o);
        }
      }
  return p.packed ? 1 : 0;
}

extern "C" int ct_copy(const float* src, int64_t s0, int64_t s1, int64_t s2, int X0, int X1,
                       int X2, float* dst, int general) {
  return copy(src, s0, s1, s2, X0, X1, X2, dst, general);
}
extern "C" int ct_copy_bf16(const float* src, int64_t s0, int64_t s1, int64_t s2, int X0,
                            int X1, int X2, brick::bf16* dst, int general) {
  return copy(src, s0, s1, s2, X0, X1, X2, dst, general);
}
extern "C" int ct_packed(const float* src, int64_t s0, int64_t s1, int64_t s2, int X2) {
  return brick::copy_packed((uint64_t)(uintptr_t)src, s0, s1, s2, X2);
}
extern "C" int ct_rows_first(int64_t s0, int64_t s1, int64_t s2) {
  return brick::make_copy_plan(0, s0, s1, s2, 4, 4, 4).rows_first;
}
"""


@pytest.fixture(scope="module")
def ctwin(tmp_path_factory):
    """The twin of brick_copy and brick_copy_bf16 (the package's brick shape)."""
    so = _build_twin(tmp_path_factory, "ctwin", _COPY_TWIN_SRC)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for fn in (so.ct_copy, so.ct_copy_bf16):
        fn.argtypes = [ptr, i64, i64, i64, i32, i32, i32, ptr, i32]
        fn.restype = i32
    so.ct_packed.argtypes = [ptr, i64, i64, i64, i32]
    so.ct_packed.restype = i32
    so.ct_rows_first.argtypes = [i64, i64, i64]
    so.ct_rows_first.restype = i32
    return so


def _copy_layouts(t):
    """``t`` (X0, X1, X2), float32 or int32, in the layouts brick_copy
    meets, by name: contiguous; permuted (Fortran strides); a slab of a
    larger density narrowed along axis 0 (the pointer s0 elements on);
    narrowed along axis 1 (rows still packed, the pointer 4 X2 elements on,
    the plane stride a multiple of 4) and along axis 2 (rows not packed);
    contiguous with the pointer one element off 16 bytes."""
    X0, X1, X2 = t.shape
    out = {"contiguous": t.contiguous(),
           "permuted": t.permute(2, 1, 0).contiguous().permute(2, 1, 0)}
    big = torch.zeros((X0 + 2, X1, X2), dtype=t.dtype, device=t.device)
    big[1:-1] = t
    out["slab axis 0"] = big.narrow(0, 1, X0)
    big = torch.zeros((X0, X1 + 4 + -X1 % 4, X2), dtype=t.dtype, device=t.device)
    big[:, 4:4 + X1] = t
    out["narrowed axis 1"] = big.narrow(1, 4, X1)
    big = torch.zeros((X0, X1, X2 + 2), dtype=t.dtype, device=t.device)
    big[:, :, 1:-1] = t
    out["narrowed axis 2"] = big.narrow(2, 1, X2)
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    out["pointer off 16 bytes"] = flat[1:].view(t.shape)
    for v in out.values():
        assert torch.equal(v.view(torch.int32), t.view(torch.int32))
    return out


def _copy_packed(t) -> bool:
    """The packed path's rule, stated here on its own (csrc/brick.cuh's
    copy_packed)."""
    s0, s1, s2 = t.stride()
    return (s2 == 1 and s1 == t.shape[2] and s0 % 4 == 0 and t.data_ptr() % 16 == 0
            and t.shape[2] <= 1024)


def _copy_values(rng, dims, kind):
    """A density of ``kind``: "random" (values bf16 rounds, with 0.0 and
    -0.0), "special" (bf16's ties, subnormals, values past its largest,
    +-inf, NaNs) or "labels" (int32 labels, many of them NaN and subnormal
    patterns as float32)."""
    if kind == "labels":
        return torch.tensor(rng.integers(-2 ** 31, 2 ** 31 - 1, dims, dtype=np.int64),
                            dtype=torch.int32)
    vol = torch.tensor(rng.normal(size=dims), dtype=torch.float32)
    flat = vol.view(-1).view(torch.int32)
    special = np.array((0x3f808000, 0x3f818000, 0x00008000, 0x00000001, 0x80123456, 0x7f7fffff,
                        0x7f7f8000, 0x7f800000, 0xff800000, 0x7fc00000, 0xffc00001, 0x00000000,
                        0x80000000) if kind == "special" else (0x00000000, 0x80000000),
                       np.uint32).view(np.int32)
    at = torch.tensor(rng.choice(vol.numel(), min(vol.numel(), 3 * len(special)), replace=False))
    flat[at] = torch.tensor(np.resize(special, at.numel()))
    return vol


def _twin_copy(ctwin, t, storage=None, general=False):
    """(the twin's copy of ``t``, its path: 1 packed, 0 general)."""
    f = t.view(torch.float32) if t.dtype == torch.int32 else t
    ext = tuple(f.shape)
    data = torch.full((*(-(-e // b) for e, b in zip(ext, brick.BRICK)), *brick.BRICK), -7.0,
                      dtype=torch.float32 if storage is None else torch.bfloat16)
    fn = ctwin.ct_copy if storage is None else ctwin.ct_copy_bf16
    path = fn(f.data_ptr(), *f.stride(), *ext, data.data_ptr(), int(general))
    assert path >= 0, "the packed plan breaks the kernel's 16-byte accesses"
    return data, path


def _assert_copy_bits(got, ref):
    """Bit for bit; in bf16 a NaN for a NaN (torch's CPU rounding keeps a
    NaN's sign, the card's and brick::to_bf16 give 0x7fff)."""
    if got.dtype == torch.bfloat16:
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(got), nan)
        got, ref = got[~nan], ref[~nan]
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), ref.view(bits))


@pytest.mark.parametrize("dims, kind", [
    ((9, 12, 1), "random"), ((6, 8, 5), "random"), ((5, 12, 133), "special"),
    ((9, 7, 133), "labels"), ((7, 6, 16), "random"), ((5, 5, 128), "special"),
    ((2, 3, 1030), "random"), ((4, 4, 4), "labels"), ((6, 5, 9), "special")],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_twin_brick_copy_equals_plain(ctwin, dims, kind):
    """The copy as brick_copy's blocks make it (csrc/brick.cuh's plan, built
    with g++) equals brick_density_plain bit for bit, in float32 and, for a
    density, in bf16 (NaN for NaN), in every layout of ``_copy_layouts``, on
    the path the header picks and on the general path: depths 1, 5, 9, 16,
    128, 133 and 1030 (two chunks of axis 2: general), X1 % 4 != 0 (the last
    column's shorter spans, of lengths not a multiple of 4 where X2 is odd),
    int32 labels that are NaN patterns as float32, bf16's ties, subnormals,
    infinities and NaNs."""
    t = _copy_values(np.random.default_rng(sum(dims)), dims, kind)
    storages = (None,) if kind == "labels" else (None, "bf16")
    paths = set()
    for name, v in _copy_layouts(t).items():
        for storage in storages:
            ref = brick_density_plain(v, storage).data
            for general in (False, True):
                got, path = _twin_copy(ctwin, v, storage, general)
                paths.add(path)
                assert path == (not general and _copy_packed(v)), name
                _assert_copy_bits(got, ref)
    assert paths == ({0} if dims[2] > 1024 else {0, 1})


def test_twin_brick_copy_picks_the_packed_path(ctwin):
    """The packed path exactly where a plane's rows of a column are one
    16-byte aligned span: a contiguous density whose plane stride is a
    multiple of 4 (the main CT's 512 x 133) and a slab of it along axis 0;
    along axis 1 where the pointer stays 16-byte aligned (rows still
    packed); not a permuted density, one narrowed along axis 2, one whose
    pointer or plane stride is off 16 bytes, nor an axis 2 past 1024. The
    general path's threads run along axis 2 where its stride is the
    smallest (a slab narrowed along it), else along the column's rows (a
    permuted density)."""
    def packed(t):
        f = t.view(torch.float32) if t.dtype == torch.int32 else t
        return bool(ctwin.ct_packed(f.data_ptr(), *f.stride(), f.shape[2]))

    ct = torch.zeros((6, 512, 133))
    layouts = _copy_layouts(ct)
    for name in ("contiguous", "slab axis 0", "narrowed axis 1"):
        assert packed(layouts[name]), name
    for name in ("permuted", "narrowed axis 2", "pointer off 16 bytes"):
        assert not packed(layouts[name]), name
    big = torch.zeros((6, 520, 133))
    assert not packed(big.narrow(1, 3, 512))  # 3 x 133 elements on: off 16 bytes
    assert not packed(torch.zeros((6, 7, 133)))  # plane stride 931
    assert packed(torch.zeros((3, 4, 1024))) and not packed(torch.zeros((3, 4, 1025)))
    assert packed(torch.zeros((3, 4, 1024), dtype=torch.int32))
    for dims in ((5, 12, 133), (9, 7, 133), (2, 3, 1030), (6, 8, 5)):
        for name, v in _copy_layouts(torch.zeros(dims)).items():
            assert packed(v) == _copy_packed(v), (dims, name)
            assert ctwin.ct_rows_first(*v.stride()) == (name == "permuted"), (dims, name)


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
@pytest.mark.parametrize("h", [1.0, 4.0, 1.37, 0.6, 511 / 499])
@pytest.mark.parametrize("axis", [0, 2])
def test_cuda_joseph_fwd_bricked_matches_plain(axis, h):
    """On a card: joseph_fwd (bricked copy) against its plain version, atol
    1e-4 * max, at 64x64 with mixed rays and at 200x200 (h = 511/499: the
    trilinear march's stride on 512 planes at n_points 500)."""
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
def test_cuda_joseph_fwd_counts_blend_launches():
    """On a card: a float32 joseph_fwd at a fractional h counts once in
    launch_counts()'s joseph_fwd and once in joseph_fwd_blend; at h = 1, and
    a bf16 one at a fractional h, in joseph_fwd_blend not at all."""
    from diffdrr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    (_, vol, geo, _), *_ = _gpu_fwd_scenes(2)
    reset_launch_counts()
    for h, storage, want in ((511 / 499, None, (1, 0, 1)), (1.0, None, (2, 0, 1)),
                             (1.37, "bf16", (2, 1, 1)), (0.6, None, (3, 1, 2))):
        rows = prep_rays(*geo, 2, vol.shape, quadrature="joseph", h=h)
        J.joseph_fwd(rows, vol, 2, h, int(-(-vol.shape[2] // h)), storage)
        got = launch_counts()
        assert (got["joseph_fwd"], got["joseph_fwd_bf16"], got["joseph_fwd_blend"]) == want, h
    reset_launch_counts()
    assert launch_counts()["joseph_fwd_blend"] == 0


def _gpu_scene_rows(axis, vol, geo, extra, **prep):
    """The rows of a ``_gpu_fwd_scenes`` scene, its mixed rays appended."""
    rows = prep_rays(*geo, axis, vol.shape, **prep)
    if extra is not None:
        rows = torch.cat([rows, prep_rays(*(t.cuda() for t in extra), axis, vol.shape, **prep)], 1)
    return rows


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cuda_siddon_fwd_max_bricked_matches_plain(axis):
    """On a card: siddon_fwd_max (kMaxLanes lanes a ray on the bricked copy)
    against its plain version, argmax exact and value atol 1e-4 * max, at
    64x64 with mixed rays and at 200x200 on a 128x128x64 volume; a second
    launch gives the same bits."""
    for label, vol, geo, extra in _gpu_fwd_scenes(axis):
        rows = _gpu_scene_rows(axis, vol, geo, extra)
        val, arg = K.siddon_fwd_max(rows, vol, axis)
        val2, arg2 = K.siddon_fwd_max(rows, vol, axis)
        ref_val, ref_arg = K.siddon_fwd_max_plain(rows, vol, axis)
        torch.cuda.synchronize()
        assert (ref_arg >= 0).sum() > rows.shape[1] // 2, label
        assert torch.equal(arg, ref_arg) and torch.equal(arg2, arg), label
        assert torch.equal(_bits(val2), _bits(val)), label
        torch.testing.assert_close(val, ref_val, rtol=0, atol=1e-4 * ref_val.abs().max().item(),
                                   msg=label)


def _nan_ray(rows):
    """``rows`` with a ray of NaN rows appended: a ray count no multiple of
    32 / G for any G > 1 above, and a ray that finds no maximum. The plain
    versions take only finite rays."""
    return torch.cat([rows, torch.full((9, 1), float("nan"), device=rows.device)], 1)


@pytest.mark.gpu
@_STRIDES
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cuda_joseph_fwd_max_lanes_match_plain(axis, h):
    """On a card: joseph_fwd_max (kMaxLanes lanes a ray on the bricked copy)
    against its plain version on the finite rays, argmax exact and value
    atol 1e-4 * max, at 64x64 with mixed rays and at 200x200, each with a
    NaN ray (value 0, argmax -1; the plain version cannot index with NaN);
    a second launch gives the same bits, and both read one copy."""
    for label, vol, geo, extra in _gpu_fwd_scenes(axis):
        rows = _nan_ray(_gpu_scene_rows(axis, vol, geo, extra, quadrature="joseph", h=h))
        n = int(-(-vol.shape[axis] // h))
        clear_cache()
        copies = brick_density.launches
        val, arg = J.joseph_fwd_max(rows, vol, axis, h, n)
        val2, arg2 = J.joseph_fwd_max(rows, vol, axis, h, n)
        ref_val, ref_arg = J.joseph_fwd_max_plain(rows[:, :-1], vol, axis, h, n)
        torch.cuda.synchronize()
        assert brick_density.launches == copies + 1, label
        assert (ref_arg >= 0).sum() > rows.shape[1] // 2, label
        assert arg[-1] == -1 and val[-1] == 0, label
        assert torch.equal(arg[:-1], ref_arg) and torch.equal(arg2, arg), label
        assert torch.equal(_bits(val2), _bits(val)), label
        torch.testing.assert_close(val[:-1], ref_val, rtol=0,
                                   atol=1e-4 * ref_val.abs().max().item(), msg=label)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flat", "two_bright_planes", "zero"])
def test_cuda_joseph_fwd_max_tie_keeps_the_first_maximum(case):
    """On a card: joseph_fwd_max on ``_joseph_tie_scene`` (23 rays) keeps
    the first of equal maxima, and -1 where no sample beats 0, as its plain
    version does, the values exactly the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows, vol, want = (t.cuda() if torch.is_tensor(t) else t for t in _joseph_tie_scene(case))
    val, arg = J.joseph_fwd_max(rows, vol, 0, 1.0, 40)
    ref_val, ref_arg = J.joseph_fwd_max_plain(rows, vol, 0, 1.0, 40)
    torch.cuda.synchronize()
    assert (arg == want).all() and torch.equal(arg, ref_arg)
    torch.testing.assert_close(val, ref_val, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("h", [1.0, 4.0, 1.37, 0.5, 0.26])
@pytest.mark.parametrize("axis", [0, 2])
def test_cuda_joseph_fwd_ch_bricked_matches_plain(axis, h):
    """On a card: joseph_fwd_ch (kFwdChLanes lanes a ray on the bricked
    copies, the sums in shared memory) equals its plain version exactly
    (the serial order of sums) at every stride of
    test_cuda_joseph_channel_kernels_match_plain_versions, at 64x64 with
    mixed rays and at 200x200, for C = 1, 3 and 7 with labels -1..C (-1 and
    C drop)."""
    rng = np.random.default_rng(30 + axis)
    for label, vol, geo, extra in _gpu_fwd_scenes(axis):
        rows = _gpu_scene_rows(axis, vol, geo, extra, quadrature="joseph", h=h)
        n = int(-(-vol.shape[axis] // h))
        for C in (1, 3, 7):
            lab = torch.tensor(rng.integers(-1, C + 1, tuple(vol.shape)), dtype=torch.int32,
                               device="cuda")
            got = J.joseph_fwd_ch(rows, vol, lab, axis, h, n, C)
            ref = J.joseph_fwd_ch_plain(rows, vol, lab, axis, h, n, C)
            torch.cuda.synchronize()
            assert (ref > 0).any(0).sum() > rows.shape[1] // 2, (label, C)
            torch.testing.assert_close(got, ref, rtol=0, atol=0, msg=f"{label} C={C}")


@pytest.mark.gpu
@pytest.mark.parametrize("n_channels", [769, 3633, 7300])
def test_cuda_joseph_fwd_ch_many_channels(n_channels):
    """On a card: joseph_fwd_ch with more channel sums than a block's
    default 48 KB of shared memory holds (C > 768 for its 16 rays: the
    kernel opts in to more), more than its opt-in limit holds (C > 3632 at
    the H100's 227 KB: two tiles of channels, one march each) and three
    tiles, equals its plain version exactly; and its bf16 instantiation
    (32 rays a block at its G = 4: opt-in past C = 384, tiles past 1816, so
    one, three and five tiles here) equals the float32 kernel on the
    density rounded to bf16 bit for bit, and its plain version exactly."""
    vol, rows, _, n = _gpu_joseph_scene(1.37)
    rng = np.random.default_rng(n_channels)
    lab = torch.tensor(rng.integers(-1, n_channels + 1, tuple(vol.shape)), dtype=torch.int32,
                       device="cuda")
    got = J.joseph_fwd_ch(rows, vol, lab, 2, 1.37, n, n_channels)
    ref = J.joseph_fwd_ch_plain(rows, vol, lab, 2, 1.37, n, n_channels)
    got_b = J.joseph_fwd_ch(rows, vol, lab, 2, 1.37, n, n_channels, "bf16")
    ref_b = J.joseph_fwd_ch(rows, _rounded(vol), lab, 2, 1.37, n, n_channels)
    plain_b = J.joseph_fwd_ch_plain(rows, vol, lab, 2, 1.37, n, n_channels, "bf16")
    torch.cuda.synchronize()
    assert (ref > 0).any(1).sum() > n_channels // 2
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert torch.equal(_bits(got_b), _bits(ref_b))
    torch.testing.assert_close(got_b, plain_b, rtol=0, atol=0)


@pytest.mark.gpu
def test_cuda_forwards_brick_once_per_version():
    """On a card: joseph_fwd_ch bricks the density and the labelmap once
    each; a second render, joseph_bwd_rays_ch and siddon_fwd_max reuse the
    copies; a write to the density makes one new copy of it, a write to the
    labelmap one of the labelmap."""
    vol, rows, g, n = _gpu_joseph_scene(1.0)
    _, srows, _ = _gpu_scene()  # the Siddon rows of the same geometry and shape
    lab = torch.tensor(np.random.default_rng(11).integers(0, 5, tuple(vol.shape)),
                       dtype=torch.int32, device="cuda")
    g5 = g[None].repeat(5, 1).contiguous()
    clear_cache()
    brick_density.launches = 0
    J.joseph_fwd_ch(rows, vol, lab, 2, 1.0, n, 5)
    assert brick_density.launches == 2
    J.joseph_fwd_ch(rows, vol, lab, 2, 1.0, n, 5)
    J.joseph_bwd_rays_ch(rows, vol, lab, 2, 1.0, n, g5)
    K.siddon_fwd_max(srows, vol, 2)
    assert brick_density.launches == 2
    vol.add_(0.0)
    J.joseph_fwd_ch(rows, vol, lab, 2, 1.0, n, 5)
    K.siddon_fwd_max(srows, vol, 2)
    assert brick_density.launches == 3
    lab.add_(0)
    J.joseph_fwd_ch(rows, vol, lab, 2, 1.0, n, 5)
    J.joseph_bwd_rays_ch(rows, vol, lab, 2, 1.0, n, g5)
    assert brick_density.launches == 4
    clear_cache()


def _cuda_copies(t, storage=None):
    """brick_density of ``t`` on the card in every layout of
    ``_copy_layouts``, each one launch of the copy's kernel: by name,
    (the copy on the host, whether it took the packed path)."""
    count = "launches" if storage is None else "launches_bf16"
    out = {}
    for name, v in _copy_layouts(t.cuda()).items():
        clear_cache()
        launches = getattr(brick_density, count)
        got = brick_density(v, storage)
        torch.cuda.synchronize()
        assert getattr(brick_density, count) == launches + 1, name
        assert got.shape == tuple(t.shape)
        assert brick.packed_path(v) == _copy_packed(v), name
        out[name] = (got.data.cpu(), brick.packed_path(v))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(21, 23, 13), (8, 8, 4), (130, 67, 133), (130, 68, 133),
                                  (9, 7, 133), (36, 40, 128), (6, 5, 1030)])
def test_cuda_brick_copy_matches_plain(dims):
    """On a card: brick_copy (csrc/brick.cu) equals the plain copy bit for
    bit, on extents that are not whole bricks, in every layout of
    ``_copy_layouts`` (contiguous, permuted, a slab, narrowed along axis 1
    and 2, the pointer off 16 bytes), on both paths (the packed one wherever
    ``_copy_packed`` says), one launch a copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vol = _copy_values(np.random.default_rng(3), dims, "random")
    ref = brick_density_plain(vol).data
    copies = _cuda_copies(vol)
    for name, (got, _) in copies.items():
        _assert_copy_bits(got, ref)
    assert {packed for _, packed in copies.values()} == ({False} if dims[2] > 1024
                                                         else {False, True})


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(130, 67, 133), (9, 7, 133), (36, 40, 128)])
def test_cuda_brick_copy_keeps_label_bits(dims):
    """On a card: brick_copy of an int32 labelmap (its bits seen as float32)
    equals the plain copy bit for bit, labels that are NaN or denormal
    patterns as float32 included, in every layout of ``_copy_layouts``, on
    both paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lab = _copy_values(np.random.default_rng(9), dims, "labels")
    ref = brick_density_plain(lab).data
    copies = _cuda_copies(lab)
    for name, (got, _) in copies.items():
        _assert_copy_bits(got, ref)
    assert {packed for _, packed in copies.values()} == {False, True}


# -----------------------------------------------------------------------------
# The fused pose kernels: G lanes a ray on the bricked copy (csrc/lanes.cuh)
# -----------------------------------------------------------------------------

_FUSED_TWIN_SRC = r"""
#include <string.h>
#include <type_traits>
#include "joseph.cuh"
#include "siddon.cuh"
// The copy's arguments, its elements of type E (float, or brick::bf16 in
// the *_bf16 entry points at the end).
#define COPY_ARGS(E) const E* bvol, int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z
#define COPY bvol, axis, bs_s, bs_y, bs_z, X, Y, Z
template <int N>
using IC = std::integral_constant<int, N>;
// f(G, U) of the variant: G lanes a ray and U slabs (steps) in flight, 0
// taking the kernel's own for the copy's element T (kFusedLanes and
// kFusedSlabsOf<T> or kFusedStepsOf<T>; kBwdLanes, kBwdSlabs or
// kBwdSteps). A bf16 copy (T not float) takes the kernel's own only, but
// in the build with FT_BF16_VARIANTS, which has the bf16 entry points
// alone, each of them at every variant.
template <class T, class F>
static void with_variant(int variant, F f) {
#if !defined(FT_BF16_VARIANTS)
  if constexpr (!std::is_same<T, float>::value) {
    f(IC<0>(), IC<0>());
    return;
  }
#endif
  switch (variant) {
    case 0: f(IC<1>(), IC<0>()); break;
    case 1: f(IC<2>(), IC<0>()); break;
    case 2: f(IC<8>(), IC<0>()); break;
    case 3: f(IC<32>(), IC<0>()); break;
    case 4: f(IC<0>(), IC<1>()); break;
    case 5: f(IC<0>(), IC<2>()); break;
    case 6: f(IC<0>(), IC<4>()); break;
    default: f(IC<0>(), IC<0>()); break;
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
template <class T>
static void ft_siddon_t(int variant, const float* rows, int64_t R, COPY_ARGS(T), float* out) {
  brick::with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    with_variant<T>(variant, [&](auto g, auto u) {
      constexpr int G = decltype(g)::value ? decltype(g)::value : siddon::kFusedLanes;
      constexpr int U = decltype(u)::value ? decltype(u)::value : siddon::kFusedSlabsOf<T>;
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
// siddon_bwd_rays' sum mode on the bricked copy, out (9, R): its lanes (G
// and U of the variant, 0 taking kBwdLanes, kBwdSlabs), the fused march's 9
// gradient rows in passes (fused_terms, lanes_march), each times g[r] once
// summed.
template <class T>
static void ft_siddon_bwd_rays_t(int variant, const float* rows, int64_t R, COPY_ARGS(T),
                                   const float* g, float* out) {
  brick::with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    with_variant<T>(variant, [&](auto lanes_g, auto u) {
      constexpr int G = decltype(lanes_g)::value ? decltype(lanes_g)::value : siddon::kBwdLanes;
      constexpr int U = decltype(u)::value ? decltype(u)::value : siddon::kBwdSlabs;
      constexpr int N = siddon::kRows;
      for (int64_t r = 0; r < R; ++r) {
        siddon::Ray ray = siddon::load_ray(rows, R, r);
        int lo, hi;
        siddon::slab_range(ray, X, &lo, &hi);
        float o[N];
        lanes_march<G, U, N>(lo, hi, false, [&](int s0, float (*tm)[N]) {
          float t[U][siddon::kFusedRows];
          siddon::fused_terms<U>(ray, v, s0, G, hi, t);
          for (int k = 0; k < U; ++k) memcpy(tm[k], t[k], sizeof(tm[k]));
        }, o, nullptr);
        for (int k = 0; k < N; ++k) out[k * R + r] = o[k] * g[r];
      }
    });
    return 0;
  });
}
// joseph_bwd_rays' sum mode on the bricked copy, out (7, R): its lanes (G
// and U of the variant, 0 taking kBwdLanes, kBwdSteps), the fused march's 7
// gradient rows in passes (fused_terms, lanes_march), each times g[r] once
// summed.
template <class T>
static void ft_joseph_bwd_rays_t(int variant, const float* rows, int64_t R, COPY_ARGS(T),
                                   float h, int n, int blend, const float* g, float* out) {
  joseph::March m;
  m.h = h;
  m.n_steps = n;
  m.blend = blend != 0;
  brick::with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    with_variant<T>(variant, [&](auto lanes_g, auto u) {
      constexpr int G = decltype(lanes_g)::value ? decltype(lanes_g)::value : joseph::kBwdLanes;
      constexpr int U = decltype(u)::value ? decltype(u)::value : joseph::kBwdSteps;
      constexpr int N = joseph::kRows;
      for (int64_t r = 0; r < R; ++r) {
        joseph::Ray ray = joseph::load_ray(rows, R, r);
        int lo, hi;
        joseph::step_range(ray, m, &lo, &hi);
        float o[N];
        lanes_march<G, U, N>(lo, hi, false, [&](int p0, float (*tm)[N]) {
          float t[U][joseph::kFusedRows];
          joseph::fused_terms<U>(ray, v, m, p0, G, hi, t);
          for (int k = 0; k < U; ++k) memcpy(tm[k], t[k], sizeof(tm[k]));
        }, o, nullptr);
        for (int i = 0; i < N; ++i) out[i * R + r] = o[i] * g[r];
      }
    });
    return 0;
  });
}
// f(G, U) of a variant of joseph_bwd_rays_ch's lanes: with_variant<T>'s, or
// in the build with CH_VARIANTS (the channel entry point alone, both copies
// at every variant) ch_variant's: G = 4, 8, 16 at U = 1, 2, 4 and the
// kernel's own.
template <class T, class F>
static void with_ch_variant(int variant, F f) {
#if defined(CH_VARIANTS)
  ch_variant(variant, f);
#else
  with_variant<T>(variant, f);
#endif
}
// joseph_bwd_rays_ch's lanes (channel_terms, G and U of the variant, 0
// taking kChannelLanesOf<T>, kChannelStepsOf<T>) on the bricked copies of
// the density and the labelmap (blab, sharing the density copy's
// arguments): out (7, R).
template <class T>
static void ft_joseph_ch_t(int variant, const float* rows, int64_t R, COPY_ARGS(T),
                             const float* blab, float h, int n, int blend, int C, const float* g,
                             float* out) {
  joseph::March m;
  m.h = h;
  m.n_steps = n;
  m.blend = blend != 0;
  brick::with_axis(axis, [&](auto a) {
    constexpr int A = decltype(a)::value;
    auto v = brick::make_volume<A>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    joseph::BrickLabels<A> l{brick::make_volume<A>(blab, bs_s, bs_y, bs_z, X, Y, Z)};
    with_ch_variant<T>(variant, [&](auto lanes_g, auto u) {
      constexpr int G = decltype(lanes_g)::value ? decltype(lanes_g)::value
                                                 : joseph::kChannelLanesOf<T>;
      constexpr int U = decltype(u)::value ? decltype(u)::value : joseph::kChannelStepsOf<T>;
      constexpr int N = joseph::kRows;
      for (int64_t r = 0; r < R; ++r) {
        joseph::Ray ray = joseph::load_ray(rows, R, r);
        int lo, hi;
        joseph::step_range(ray, m, &lo, &hi);
        float o[N];
        lanes_march<G, U, N>(lo, hi, false, [&](int p0, float (*tm)[N]) {
          joseph::channel_terms<U>(ray, v, l, m, C, g + r, R, p0, G, hi, tm);
        }, o, nullptr);
        for (int i = 0; i < N; ++i) out[i * R + r] = o[i];
      }
    });
    return 0;
  });
}
// Returns the number of rays whose lanes' maxima differ after the tree.
template <class T>
static int ft_joseph_t(int variant, int mip, const float* rows, int64_t R, COPY_ARGS(T), float h,
                         int n, int blend, float* out, int* arg) {
  joseph::March m;
  m.h = h;
  m.n_steps = n;
  m.blend = blend != 0;
  int bad = 0;
  brick::with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    with_variant<T>(variant, [&](auto g, auto u) {
      constexpr int G = decltype(g)::value ? decltype(g)::value : joseph::kFusedLanes;
      constexpr int U = decltype(u)::value ? decltype(u)::value : joseph::kFusedStepsOf<T>;
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
// The MIP pose backwards on a bricked copy (trace_bwd_rays gated to the
// argmax, as siddon_bwd_rays_mip_bf16 and joseph_bwd_rays_mip_bf16 run it).
template <class T>
static void ft_siddon_bwd_rays_mip_t(const float* rows, int64_t R, COPY_ARGS(T), const float* g,
                                     const int* arg, float* out) {
  brick::with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    float acc[siddon::kRows];
    for (int64_t r = 0; r < R; ++r) {
      siddon::trace_bwd_rays(siddon::load_ray(rows, R, r), v, g[r], arg[r], true, acc);
      for (int k = 0; k < siddon::kRows; ++k) out[k * R + r] = acc[k];
    }
    return 0;
  });
}
template <class T>
static void ft_joseph_bwd_rays_mip_t(const float* rows, int64_t R, COPY_ARGS(T), float h, int n,
                                     int blend, const float* g, const int* arg, float* out) {
  joseph::March m;
  m.h = h;
  m.n_steps = n;
  m.blend = blend != 0;
  brick::with_axis(axis, [&](auto a) {
    auto v = brick::make_volume<decltype(a)::value>(bvol, bs_s, bs_y, bs_z, X, Y, Z);
    float acc[joseph::kRows];
    for (int64_t r = 0; r < R; ++r) {
      joseph::trace_bwd_rays(joseph::load_ray(rows, R, r), v, m, g[r], arg[r], true, acc);
      for (int i = 0; i < joseph::kRows; ++i) out[i * R + r] = acc[i];
    }
    return 0;
  });
}
// The C entry points: each function above on a float32 copy (every
// variant) and, as *_bf16, on a bf16 copy (the kernels' own variant; with
// FT_BF16_VARIANTS these alone, at every variant; with CH_VARIANTS the
// channel lanes alone, CH_ENTRY, on both copies at every variant).
#define ENTRIES(S, E)                                                                          \
  extern "C" void ft_siddon##S(int variant, const float* rows, int64_t R, COPY_ARGS(E),       \
                               float* out) {                                                   \
    ft_siddon_t(variant, rows, R, COPY, out);                                                  \
  }                                                                                            \
  extern "C" void ft_siddon_bwd_rays##S(int variant, const float* rows, int64_t R,            \
                                        COPY_ARGS(E), const float* g, float* out) {            \
    ft_siddon_bwd_rays_t(variant, rows, R, COPY, g, out);                                      \
  }                                                                                            \
  extern "C" void ft_joseph_bwd_rays##S(int variant, const float* rows, int64_t R,            \
                                        COPY_ARGS(E), float h, int n, int blend,               \
                                        const float* g, float* out) {                          \
    ft_joseph_bwd_rays_t(variant, rows, R, COPY, h, n, blend, g, out);                         \
  }                                                                                            \
  CH_ENTRY(S, E)                                                                               \
  extern "C" int ft_joseph##S(int variant, int mip, const float* rows, int64_t R,             \
                              COPY_ARGS(E), float h, int n, int blend, float* out, int* arg) { \
    return ft_joseph_t(variant, mip, rows, R, COPY, h, n, blend, out, arg);                    \
  }                                                                                            \
  extern "C" void ft_siddon_bwd_rays_mip##S(const float* rows, int64_t R, COPY_ARGS(E),       \
                                            const float* g, const int* arg, float* out) {      \
    ft_siddon_bwd_rays_mip_t(rows, R, COPY, g, arg, out);                                      \
  }                                                                                            \
  extern "C" void ft_joseph_bwd_rays_mip##S(const float* rows, int64_t R, COPY_ARGS(E),       \
                                            float h, int n, int blend, const float* g,         \
                                            const int* arg, float* out) {                      \
    ft_joseph_bwd_rays_mip_t(rows, R, COPY, h, n, blend, g, arg, out);                         \
  }
#define CH_ENTRY(S, E)                                                                         \
  extern "C" void ft_joseph_ch##S(int variant, const float* rows, int64_t R, COPY_ARGS(E),    \
                                  const float* blab, float h, int n, int blend, int C,         \
                                  const float* g, float* out) {                                \
    ft_joseph_ch_t(variant, rows, R, COPY, blab, h, n, blend, C, g, out);                      \
  }
#if defined(CH_VARIANTS)
CH_ENTRY(, float)
CH_ENTRY(_bf16, brick::bf16)
#else
ENTRIES(_bf16, brick::bf16)
#endif
#if !defined(FT_BF16_VARIANTS) && !defined(CH_VARIANTS)
ENTRIES(, float)
// brick::to_bf16 (the bf16 copy's rounding) on the host: out[i] = the bits
// of x[i] rounded to the nearest bf16, ties to even.
extern "C" void ft_to_bf16(const float* x, int64_t n, brick::bf16* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = brick::to_bf16(x[i]);
}
#endif
"""

# (G, U) of each variant of the twin (None: the kernel's own), in its order.
_FUSED_VARIANTS = ((1, None), (2, None), (8, None), (32, None),
                   (None, 1), (None, 2), (None, 4), (None, None))
_LANES = (0, 1, 2, 3)  # G = 1, 2, 8, 32, each with the kernel's U
_UNROLLED = (4, 5, 6)  # the kernel's G with U = 1, 2, 4
_OWN = 7  # the kernel's own G and U


def _fused_entries(so, suffixes):
    """Sets the argument and result types of the fused twin's entry points
    with each of ``suffixes`` ("" the float32 copy's, "_bf16" the bf16
    copy's: the same arguments)."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    bvol = [ptr] + [i32] * 7
    args = {
        "ft_siddon": [i32, ptr, i64] + bvol + [ptr],
        "ft_joseph": [i32, i32, ptr, i64] + bvol + [ctypes.c_float, i32, i32, ptr, ptr],
        "ft_joseph_ch": [i32, ptr, i64] + bvol + [ptr, ctypes.c_float, i32, i32, i32, ptr, ptr],
        "ft_siddon_bwd_rays": [i32, ptr, i64] + bvol + [ptr, ptr],
        "ft_joseph_bwd_rays": [i32, ptr, i64] + bvol + [ctypes.c_float, i32, i32, ptr, ptr],
        "ft_siddon_bwd_rays_mip": [ptr, i64] + bvol + [ptr, ptr, ptr],
        "ft_joseph_bwd_rays_mip": [ptr, i64] + bvol + [ctypes.c_float, i32, i32, ptr, ptr, ptr],
    }
    for fn, types in args.items():
        for suffix in suffixes:
            f = getattr(so, fn + suffix)
            f.argtypes = types
            f.restype = i32 if fn == "ft_joseph" else None
    return so


@pytest.fixture(scope="module")
def ftwin_bf16(tmp_path_factory):
    """The fused twin's bf16 entry points alone, each at every variant of
    ``_FUSED_VARIANTS`` (the kernels' own: kFusedLanes and
    kFusedSlabsOf<bf16> or kFusedStepsOf<bf16>)."""
    so = _build_twin(tmp_path_factory, "ftwin_bf16", _FUSED_TWIN_SRC, ("FT_BF16_VARIANTS",))
    return _fused_entries(so, ("_bf16",))


@pytest.fixture(scope="module")
def ftwin(tmp_path_factory):
    """The twin of the fused kernels' lanes (the package's brick shape)."""
    so = _build_twin(tmp_path_factory, "ftwin", _FUSED_TWIN_SRC)
    _fused_entries(so, ("", "_bf16"))
    so.ft_to_bf16.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    so.ft_to_bf16.restype = None
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


def _bwd_rays_lanes(ftwin, variant, rows, vol, axis, g):
    """(9, R) of the twin's siddon_bwd_rays sum-mode lanes (the variant) on
    ``vol``'s bricked copy."""
    rows = rows.contiguous()
    bv = brick_density(vol)
    out = torch.full((9, rows.shape[1]), float("nan"))
    ftwin.ft_siddon_bwd_rays(variant, rows.data_ptr(), rows.shape[1], bv.data.data_ptr(),
                             *bv.args(axis), g.data_ptr(), out.data_ptr())
    return out


def _bwd_rays_case(axis, seed, **prep):
    """(density, its Fortran-ordered copy, rows, g) of the two-pass
    backwards' cases: ``_fwd_rays`` on ``_BRICK_DIMS`` (``prep``: prep_rays'
    quadrature and stride) and a random cotangent that is 0 on every fifth
    ray."""
    rng = np.random.default_rng(seed)
    vol, vol_f = _densities(rng, _BRICK_DIMS)
    rows = _fwd_rays(rng, _BRICK_DIMS, axis, **prep)
    g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32)
    g[::5] = 0.0
    return vol, vol_f, rows, g


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_siddon_bwd_rays_lanes_equal_serial(twin, ftwin, axis):
    """siddon_bwd_rays' sum-mode lanes on the bricked copy (fused_terms and
    take_in_order in passes of G * U slabs, then one product by g) at G = 1,
    2, 8, 32, at the kernel's G with U = 1, 2, 4 and at the kernel's own:
    the strided serial trace_bwd_rays bit for bit, every ray (off-grid,
    long, short and missing rays, partial entry slabs, the NaN ray, extents
    not whole bricks), contiguous and permuted density, a cotangent with
    zeros. (The serial rows against the plain version, and the MIP mode,
    the strided serial kernel's: test_twin_backward_matches_plain_random_rays.)"""
    vol, vol_f, rows, g = _bwd_rays_case(axis, 250 + axis)
    serial = _bits(_run_twin_bwd_rays(twin, rows, vol, axis, g, None))
    assert (serial != 0).any(0).sum() > rows.shape[1] // 2
    for variant in _LANES + _UNROLLED + (_OWN,):
        for v in (vol, vol_f):
            got = _bwd_rays_lanes(ftwin, variant, rows, v, axis, g)
            assert torch.equal(_bits(got), serial), (_FUSED_VARIANTS[variant], v.is_contiguous())


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_siddon_bwd_rays_equal_fused_rows_times_g(twin, ftwin, axis):
    """The two-pass pose backward's sum-mode rows, from its lanes on the
    bricked copy at the kernel's G and U and from the strided serial
    trace_bwd_rays, are siddon_fwdgrad's rows 0-8 (its lanes at the kernel's
    G and U, and the strided serial trace_fwdgrad) times g bit for bit: the
    fused and the two-pass pose gradients agree to the last bit."""
    vol, _, rows, g = _bwd_rays_case(axis, 260 + axis)
    want = _bits(_run_twin(twin, True, rows, vol, axis)[:9] * g)
    assert torch.equal(_bits(_fused_siddon(ftwin, _OWN, rows, vol, axis)[:9] * g), want)
    assert torch.equal(_bits(_run_twin_bwd_rays(twin, rows, vol, axis, g, None)), want)
    assert torch.equal(_bits(_bwd_rays_lanes(ftwin, _OWN, rows, vol, axis, g)), want)


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cuda_siddon_bwd_rays_lanes_match_plain(axis):
    """On a card: siddon_bwd_rays in sum mode (kBwdLanes lanes a ray on the
    bricked copy) is siddon_fwdgrad's rows 0-8 times g bit for bit, and in
    either mode (MIP: one thread per ray on the density itself) its plain
    version to 1e-3 * max|row| on the finite rays; at 64x64 with mixed
    rays and at 200x200, each with a NaN ray, a cotangent that is 0 on
    every fifth ray and MIP argmaxes of -1; the forwards make one copy and
    the sum mode reads it; a second launch gives the same bits."""
    rng = np.random.default_rng(40 + axis)
    for label, vol, geo, extra in _gpu_fwd_scenes(axis):
        rows = _nan_ray(_gpu_scene_rows(axis, vol, geo, extra))
        g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32, device="cuda")
        g[::5] = 0.0
        clear_cache()
        copies = brick_density.launches
        fused = K.siddon_fwdgrad(rows, vol, axis)
        arg = K.siddon_fwd_max(rows, vol, axis)[1]
        got = K.siddon_bwd_rays(rows, vol, axis, g)
        again = K.siddon_bwd_rays(rows, vol, axis, g)
        got_mip = K.siddon_bwd_rays(rows, vol, axis, g, arg)
        torch.cuda.synchronize()
        assert brick_density.launches == copies + 1, label
        assert (arg == -1).any() and (arg >= 0).sum() > rows.shape[1] // 2, label
        assert torch.equal(_bits(got), _bits(fused[:9] * g)), label
        assert torch.equal(_bits(again), _bits(got)), label
        for out, a in ((got, None), (got_mip, arg[:-1])):
            ref = K.siddon_bwd_rays_plain(rows[:, :-1], vol, axis, g[:-1], a)
            for k in range(9):
                torch.testing.assert_close(out[k, :-1], ref[k], rtol=0,
                                           atol=1e-3 * ref[k].abs().max().item() + 1e-30,
                                           msg=f"{label} {'mip' if a is not None else 'sum'}")


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [0, 2])
def test_cuda_siddon_two_pass_pose_gradient_equals_fused(axis):
    """On a card: through siddon_slab_raycast, the gradient of sum(img**2)
    with respect to the sources and targets with fused=False (siddon_fwd,
    then siddon_bwd_rays' sum-mode lanes) equals the fused one
    (siddon_fwdgrad's rows times g) to the last bit, and so do the images;
    all four launches read one bricked copy."""
    for label, vol, geo, _ in _gpu_fwd_scenes(axis):
        res = []
        clear_cache()
        copies = brick_density.launches
        K.reset_launch_counts()
        for fused in (True, False):
            src, tgt = (t.clone().requires_grad_(True) for t in geo[:2])
            img = K.siddon_slab_raycast(vol, src, tgt, geo[2], axis=axis, fused=fused)
            (img ** 2).sum().backward()
            res.append([img.detach(), src.grad, tgt.grad])
        torch.cuda.synchronize()
        assert brick_density.launches == copies + 1, label
        assert (K.siddon_fwdgrad.launches, K.siddon_fwd.launches,
                K.siddon_bwd_rays.launches) == (1, 1, 1), label
        assert res[0][2].abs().max() > 0, label
        for a, b in zip(*res):
            assert torch.equal(_bits(a), _bits(b)), label


def _joseph_bwd_rays_lanes(ftwin, variant, rows, vol, axis, h, n, g):
    """(7, R) of the twin's joseph_bwd_rays sum-mode lanes (the variant) on
    ``vol``'s bricked copy."""
    rows = rows.contiguous()
    bv = brick_density(vol)
    out = torch.full((7, rows.shape[1]), float("nan"))
    ftwin.ft_joseph_bwd_rays(variant, rows.data_ptr(), rows.shape[1], bv.data.data_ptr(),
                             *bv.args(axis), h, n, int(J.is_blend(h)), g.data_ptr(),
                             out.data_ptr())
    return out


@_FUSED_H
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_bwd_rays_lanes_equal_serial(jtwin, ftwin, axis, h):
    """joseph_bwd_rays' sum-mode lanes on the bricked copy (fused_terms and
    take_in_order in passes of G * U steps, then one product by g) at G = 1,
    2, 8, 32, at the kernel's G with U = 1, 2, 4 and at the kernel's own,
    integer and fractional h: the strided serial trace_bwd_rays bit for
    bit, every ray (off-grid, long, short and missing rays, partial entry
    steps, the NaN ray, extents not whole bricks), contiguous and permuted
    density, a cotangent with zeros; the serial rows against
    joseph_bwd_rays_plain to 1e-6 * max|row| on the finite rays. (The MIP
    mode, the strided serial kernel's: test_twin_joseph_matches_plain.)"""
    vol, vol_f, rows, g = _bwd_rays_case(axis, 270 + axis, quadrature="joseph", h=h)
    n = int(-(-_BRICK_DIMS[axis] // h))
    serial = _JosephTwin(jtwin, rows, vol, axis, h, n).bwd_rays(g, None)
    _assert_rows_close(serial[:, :-1], J.joseph_bwd_rays_plain(rows[:, :-1], vol, axis, h, n,
                                                               g[:-1]))
    assert (serial != 0).any(0).sum() > rows.shape[1] // 2
    for variant in _LANES + _UNROLLED + (_OWN,):
        for v in (vol, vol_f):
            got = _joseph_bwd_rays_lanes(ftwin, variant, rows, v, axis, h, n, g)
            assert torch.equal(_bits(got), _bits(serial)), (_FUSED_VARIANTS[variant],
                                                            v.is_contiguous())


@_FUSED_H
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_bwd_rays_equal_fused_rows_times_g(jtwin, ftwin, axis, h):
    """The Joseph two-pass pose backward's sum-mode rows, from its lanes on
    the bricked copy at the kernel's G and U and from the strided serial
    trace_bwd_rays, are joseph_fwdgrad's rows 0-6 (its lanes at the
    kernel's G and U, and the strided serial trace_fwdgrad) times g bit for
    bit: the fused and the two-pass pose gradients agree to the last bit."""
    vol, _, rows, g = _bwd_rays_case(axis, 280 + axis, quadrature="joseph", h=h)
    n = int(-(-_BRICK_DIMS[axis] // h))
    tw = _JosephTwin(jtwin, rows, vol, axis, h, n)
    want = _bits(tw.fwdgrad(False)[0][:7] * g)
    fused = _fused_joseph(ftwin, _OWN, False, rows, vol, axis, h, n)[0]
    assert torch.equal(_bits(fused[:7] * g), want)
    assert torch.equal(_bits(tw.bwd_rays(g, None)), want)
    assert torch.equal(_bits(_joseph_bwd_rays_lanes(ftwin, _OWN, rows, vol, axis, h, n, g)), want)


@pytest.mark.gpu
@_FUSED_H
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cuda_joseph_bwd_rays_lanes_match_plain(axis, h):
    """On a card: joseph_bwd_rays in sum mode (kBwdLanes lanes a ray on the
    bricked copy) is joseph_fwdgrad's rows 0-6 times g bit for bit, and in
    either mode (MIP: one thread per ray on the density itself) its plain
    version to 1e-3 * max|row| on the finite rays; at 64x64 with mixed
    rays and at 200x200, integer and fractional h, each with a NaN ray, a
    cotangent that is 0 on every fifth ray and MIP argmaxes of -1; the
    forwards make one copy and the sum mode reads it; a second launch gives
    the same bits."""
    rng = np.random.default_rng(50 + axis)
    for label, vol, geo, extra in _gpu_fwd_scenes(axis):
        rows = _nan_ray(_gpu_scene_rows(axis, vol, geo, extra, quadrature="joseph", h=h))
        n = int(-(-vol.shape[axis] // h))
        g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32, device="cuda")
        g[::5] = 0.0
        clear_cache()
        copies = brick_density.launches
        fused = J.joseph_fwdgrad(rows, vol, axis, h, n)[0]
        arg = J.joseph_fwd_max(rows, vol, axis, h, n)[1]
        got = J.joseph_bwd_rays(rows, vol, axis, h, n, g)
        again = J.joseph_bwd_rays(rows, vol, axis, h, n, g)
        got_mip = J.joseph_bwd_rays(rows, vol, axis, h, n, g, arg)
        torch.cuda.synchronize()
        assert brick_density.launches == copies + 1, label
        assert (arg == -1).any() and (arg >= 0).sum() > rows.shape[1] // 2, label
        assert torch.equal(_bits(got), _bits(fused[:7] * g)), label
        assert torch.equal(_bits(again), _bits(got)), label
        for out, a in ((got, None), (got_mip, arg[:-1])):
            ref = J.joseph_bwd_rays_plain(rows[:, :-1], vol, axis, h, n, g[:-1], a)
            for k in range(7):
                torch.testing.assert_close(out[k, :-1], ref[k], rtol=0,
                                           atol=1e-3 * ref[k].abs().max().item() + 1e-30,
                                           msg=f"{label} {'mip' if a is not None else 'sum'}")


@pytest.mark.gpu
@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("h", [1.0, 1.37], ids=["h1", "h1.37"])
@pytest.mark.parametrize("axis", [0, 2])
def test_cuda_joseph_two_pass_pose_gradient_equals_fused(axis, h, reduce):
    """On a card: through joseph_march_raycast, the gradient of sum(img**2)
    with respect to the sources and targets with fused=False (joseph_fwd,
    then joseph_bwd_rays' sum-mode lanes; under max joseph_fwd_max, then the
    MIP backward) equals the fused one (joseph_fwdgrad's rows times g), and
    so do the images; all launches read one bricked copy. In sum mode to
    the last bit. Under max the values are equal, but not always the bits:
    the serial MIP backward adds the argmax step's terms to +0, which turns
    a -0 term into +0 where the fused rows keep it, so only the sign of a
    zero can differ."""
    for label, vol, geo, _ in _gpu_fwd_scenes(axis):
        res = []
        clear_cache()
        copies = brick_density.launches
        J.reset_launch_counts()
        for fused in (True, False):
            src, tgt = (t.clone().requires_grad_(True) for t in geo[:2])
            img = J.joseph_march_raycast(vol, src, tgt, geo[2], axis=axis, step=h,
                                         reduce=reduce, fused=fused)
            (img ** 2).sum().backward()
            res.append([img.detach(), src.grad, tgt.grad])
        torch.cuda.synchronize()
        fwd = J.joseph_fwd if reduce == "sum" else J.joseph_fwd_max
        assert brick_density.launches == copies + 1, label
        assert (J.joseph_fwdgrad.launches, fwd.launches,
                J.joseph_bwd_rays.launches) == (1, 1, 1), label
        assert res[0][2].abs().max() > 0, label
        for a, b in zip(*res):
            if reduce == "sum":
                assert torch.equal(_bits(a), _bits(b)), label
            else:
                assert torch.equal(a, b), label


def _channel_lanes(ftwin, variant, rows, vol, lab, axis, h, n, g):
    """(7, R) of the twin's channel lanes on the bricked copies of ``vol``
    and of the labelmap ``lab``."""
    rows = rows.contiguous()
    bv, bl = brick_density(vol), brick_density(lab)
    out = torch.full((7, rows.shape[1]), float("nan"))
    ftwin.ft_joseph_ch(variant, rows.data_ptr(), rows.shape[1], bv.data.data_ptr(),
                       *bv.args(axis), bl.data.data_ptr(), h, n, int(J.is_blend(h)), g.shape[0],
                       g.data_ptr(), out.data_ptr())
    return out


@_CHANNELS
@_FUSED_H
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_channel_lanes_equal_serial(jtwin, ftwin, axis, h, n_channels):
    """joseph_bwd_rays_ch's lanes (channel_terms and take_in_order, passes of
    G * U steps) on the bricked copies of the density and the labelmap, at
    G = 1, 2, 8 and 32 and at the kernel's G with U = 1, 2 and 4: the
    strided serial trace_bwd_rays_ch bit for bit on the mixed rays (long,
    short and missing), labels that drop and rays of a zero cotangent; the
    serial rows against joseph_bwd_rays_ch_plain to 1e-6 * max|row|."""
    vol, rows, _, n = _joseph_warp_scene(axis, h, 70 + axis)
    lab, g = _channel_case(rows, n_channels, 170 + axis)
    serial = _JosephTwin(jtwin, rows, vol, axis, h, n).bwd_rays_ch(lab, g)
    _assert_rows_close(serial, J.joseph_bwd_rays_ch_plain(rows, vol, lab, axis, h, n, g))
    assert (serial != 0).any(0).sum() > rows.shape[1] // 2
    for variant in _LANES + _UNROLLED:
        got = _channel_lanes(ftwin, variant, rows, vol, lab, axis, h, n, g)
        assert torch.equal(_bits(got), _bits(serial)), _FUSED_VARIANTS[variant]


# -----------------------------------------------------------------------------
# bf16 storage: the kernels' bf16 instantiations and the copy's rounding
# -----------------------------------------------------------------------------


def _rounded(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _copies(vol):
    """(the bf16 bricked copy of ``vol``, the float32 bricked copy of ``vol``
    rounded to bf16): a bf16 instantiation on the first must give the float32
    one's bits on the second."""
    bf, f32 = brick_density(vol, "bf16"), brick_density(_rounded(vol))
    assert bf.storage == "bf16" and f32.storage is None
    return bf, f32


def _on_copy(so, fn, copy, axis, head=(), tail=()):
    """``so.fn`` (``fn_bf16`` on a bf16 copy)(*head, the copy, *tail)."""
    return getattr(so, copy.entry(fn))(*head, copy.data.data_ptr(), *copy.args(axis), *tail)


def _out(*shape, dtype=torch.float32):
    return torch.full(shape, -7, dtype=dtype)


# Extents that are not whole 4x4x4 bricks, so the copy's padded bricks are read.
_SPECIAL_DIMS = (13, 10, 7)
# -0.0, the least subnormal and a subnormal tie (both round to zero bits),
# subnormals that bf16 keeps (one negative), a value that rounds past the
# largest bf16 to inf, +inf, -inf and a NaN; each at two random voxels.
_SPECIAL_BITS = (0x80000000, 0x00000001, 0x00008000, 0x00400000, 0x80123456, 0x7f7fffff,
                 0x7f800000, 0xff800000, 0x7fc00000)


def _axis_rays(dims, axis, **prep):
    """Rays parallel to ``axis`` (each slab has zero-length segments, whose
    reads are skipped): inside the volume, on the transverse voxel
    boundaries and on its faces, and wholly outside it."""
    ya, za = [a for a in range(3) if a != axis]
    yz = [(0.3, 0.2), (2.5, 3.5), (dims[ya] / 2 - 0.5, 1.0), (-0.5, 2.0), (dims[ya] - 0.5, 0.0),
          (1.0, dims[za] - 0.5), (-3.0, 2.0), (2.0, dims[za] + 4.0)]
    pts = []
    for s in (-20.0, dims[axis] + 20.0):
        p = np.zeros((len(yz), 1, 3))
        p[:, 0, axis] = s
        p[:, 0, ya], p[:, 0, za] = zip(*yz)
        pts.append(torch.tensor(p, dtype=torch.float32))
    return prep_rays(pts[0], pts[1], torch.ones((len(yz), 1, 1)), axis, dims, **prep)


def _bf16_scene(scene, rng, axis, **prep):
    """(density, rows) of a bf16 twin case along ``axis``. "random": a
    density of values that bf16 rounds on ``_BRICK_DIMS`` and ``_fwd_rays``
    (their last ray of NaN rows). "special": the same on ``_SPECIAL_DIMS``
    with ``_SPECIAL_BITS`` at random voxels and a NaN in the way of the
    first of the rays parallel to the march axis put ahead of
    ``_fwd_rays``."""
    dims = _BRICK_DIMS if scene == "random" else _SPECIAL_DIMS
    vol = torch.tensor(rng.uniform(0.1, 1.0, dims), dtype=torch.float32)
    assert not torch.equal(_rounded(vol), vol)
    rows = _fwd_rays(rng, dims, axis, **prep)
    if scene == "special":
        at = torch.tensor(rng.choice(vol.numel(), 2 * len(_SPECIAL_BITS), replace=False))
        bits = np.array(_SPECIAL_BITS * 2, np.uint32).view(np.int32)
        vol.view(-1).view(torch.int32)[at] = torch.tensor(bits)
        nan_at = [0, 0, 0]
        nan_at[axis] = dims[axis] // 2
        vol[tuple(nan_at)] = float("nan")  # on the first ray of _axis_rays
        rows = torch.cat([_axis_rays(dims, axis, **prep), rows], 1)
    return vol, rows.contiguous()


def _reached(scene):
    """How many rays of a scene must reach the density (a positive sum, an
    argmax, a nonzero MIP row): more than 80 of "random"'s 113 rays, more
    than 40 finite ones of "special"'s 121, where the infinities and NaNs
    take many."""
    return 80 if scene == "random" else 40


def _assert_reached(scene, fwd):
    """The forward's values on a scene's rays hold what the scene is for:
    many finite positive sums, and for "special" also infinities and NaNs
    from the density."""
    assert (torch.isfinite(fwd) & (fwd > 0)).sum() > _reached(scene)
    if scene == "special":
        assert torch.isinf(fwd).any() and torch.isnan(fwd).any()


def test_twin_to_bf16_matches_torch(ftwin):
    """brick::to_bf16 on the host (round to nearest, ties to even) against
    torch.Tensor.to(torch.bfloat16): ties both ways, values just off a tie,
    subnormals (and their ties), the largest bf16 and the first value that
    rounds past it to inf, +-inf, zeros, and every 32-bit pattern of a
    random sample; bit for bit, a NaN to a NaN (torch's own NaN bits differ
    between its CPU conversion, 0xffff, and its CUDA one, 0x7fff, which
    brick_copy_bf16 gives on the card)."""
    special = np.array([0x00000000, 0x80000000, 0x3f808000, 0x3f818000, 0x3f808001,
                        0x3f807fff, 0xbf808000, 0xbf818000, 0x00008000, 0x00018000,
                        0x00000001, 0x80000001, 0x007fffff, 0x00800000, 0x7f7f7fff,
                        0x7f7f8000, 0x7f7fffff, 0xff7f8000, 0x7f800000, 0xff800000,
                        0x7fc00000, 0xffc00000, 0x7f800001, 0x7fbfffff], np.uint32)
    rng = np.random.default_rng(5)
    bits = np.concatenate([special, rng.integers(0, 2 ** 32, 20000, dtype=np.uint32)])
    x = torch.tensor(bits.view(np.float32))
    got = torch.empty(x.numel(), dtype=torch.int16)
    ftwin.ft_to_bf16(x.data_ptr(), x.numel(), got.data_ptr())
    ref = x.to(torch.bfloat16)
    nan = torch.isnan(x)
    assert nan.sum() > 20
    assert torch.isnan(got.view(torch.bfloat16)[nan]).all()
    assert torch.equal(got[~nan], ref.view(torch.int16)[~nan])
    assert got[2].item() == 0x3f80 and got[3].item() == 0x3f82  # ties to even


@pytest.mark.parametrize("scene", ["random", "special"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_siddon_bf16_instantiations_equal_f32_on_rounded(twin, btwin, ftwin, axis, scene):
    """Every Siddon kernel that reads the density, its bf16 instantiation on
    the bf16 bricked copy against the float32 one on the float32 copy of the
    density rounded to bf16, at the kernels' own lanes: siddon_fwd (its raw
    reads at every unroll, 1 to 8 slabs in flight and the kernel's own),
    siddon_fwd_max (values and argmaxes), siddon_fwdgrad and the two-pass
    backward's sum mode, bit for bit, on every ray (off-grid, long, short,
    missing, partial entry slabs, parallel to the march axis, the NaN ray);
    and the MIP backward on the bf16 copy against the strided serial
    trace_bwd_rays on the rounded density (``_bf16_scene``: the density
    spans values that bf16 rounds, and in "special" -0.0, subnormals, +-inf
    and NaN on extents of partial bricks)."""
    rng = np.random.default_rng(300 + axis)
    vol, rows = _bf16_scene(scene, rng, axis)
    R = rows.shape[1]
    g = torch.tensor(rng.normal(size=R), dtype=torch.float32)
    so = btwin(brick.BRICK)
    own = len(_FWD_VARIANTS) - 1
    res = {}
    for copy in _copies(vol):
        fwds = []
        for unroll in _UNROLLS:
            fwds.append(_out(R))
            _on_copy(so, "bt_siddon", copy, axis, (unroll, rows.data_ptr(), R),
                     (fwds[-1].data_ptr(),))
        val, arg = _out(R), _out(R, dtype=torch.int32)
        assert _on_copy(so, "bt_siddon_max", copy, axis, (own, rows.data_ptr(), R),
                        (val.data_ptr(), arg.data_ptr())) == 0
        fused, bwd, mip = _out(10, R), _out(9, R), _out(9, R)
        _on_copy(ftwin, "ft_siddon", copy, axis, (_OWN, rows.data_ptr(), R), (fused.data_ptr(),))
        _on_copy(ftwin, "ft_siddon_bwd_rays", copy, axis, (_OWN, rows.data_ptr(), R),
                 (g.data_ptr(), bwd.data_ptr()))
        _on_copy(ftwin, "ft_siddon_bwd_rays_mip", copy, axis, (rows.data_ptr(), R),
                 (g.data_ptr(), arg.data_ptr(), mip.data_ptr()))
        res[copy.storage] = (*fwds, val, arg, fused, bwd, mip)
    names = [f"fwd unroll {u}" for u in _UNROLLS] + [
        "max", "argmax", "fwdgrad", "bwd_rays", "bwd_rays_mip"]
    for name, a, b in zip(names, res["bf16"], res[None]):
        assert torch.equal(_bits(a), _bits(b)), name
    for name, a in zip(names[1:len(_UNROLLS)], res["bf16"][1:len(_UNROLLS)]):
        assert torch.equal(_bits(a), _bits(res["bf16"][0])), name
    fwd, (val, arg, fused, bwd, mip) = res["bf16"][0], res["bf16"][len(_UNROLLS):]
    _assert_reached(scene, fwd)
    assert (arg >= 0).sum() > _reached(scene)
    strided = _run_twin_bwd_rays(twin, rows, _rounded(vol), axis, g, arg)
    assert torch.equal(_bits(mip), _bits(strided)) and torch.count_nonzero(mip) > _reached(scene)


@pytest.mark.parametrize("scene", ["random", "special"])
@pytest.mark.parametrize("h", [1.0, 1.37], ids=["h1", "h1.37"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_bf16_instantiations_equal_f32_on_rounded(jtwin, btwin, ftwin, axis, h,
                                                              scene):
    """Every Joseph kernel that reads the density, as the Siddon test above:
    joseph_fwd (its raw windows at every unroll, 1 to 8 steps in flight and
    the kernel's own), joseph_fwd_max, joseph_fwdgrad (sum and max), the
    two-pass backward's sum mode, joseph_fwd_ch and joseph_bwd_rays_ch (the
    labelmap's copy its int32 bits in both) at the kernels' own lanes, bit
    for bit, and the MIP backward on the bf16 copy against the strided
    serial trace_bwd_rays on the rounded density; integer h and fractional
    h (blend mode: two planes a window)."""
    rng = np.random.default_rng(310 + axis)
    vol, rows = _bf16_scene(scene, rng, axis, quadrature="joseph", h=h)
    dims = tuple(vol.shape)
    C = 3
    lab = torch.tensor(rng.integers(-1, C + 1, dims), dtype=torch.int32)
    R = rows.shape[1]
    n = int(-(-dims[axis] // h))
    march = (h, n, int(J.is_blend(h)))
    g = torch.tensor(rng.normal(size=R), dtype=torch.float32)
    gc = torch.tensor(rng.normal(size=(C, R)), dtype=torch.float32)
    blab = brick_density(lab)
    so = btwin(brick.BRICK)
    own = len(_FWD_VARIANTS) - 1
    res = {}
    for copy in _copies(vol):
        fwds = []
        for unroll in _UNROLLS:
            fwds.append(_out(R))
            _on_copy(so, "bt_joseph", copy, axis, (unroll, rows.data_ptr(), R),
                     (*march, fwds[-1].data_ptr()))
        val, arg = _out(R), _out(R, dtype=torch.int32)
        assert _on_copy(so, "bt_joseph_max", copy, axis, (own, rows.data_ptr(), R),
                        (*march, val.data_ptr(), arg.data_ptr())) == 0
        ch = _out(C, R)
        _on_copy(so, "bt_joseph_ch", copy, axis, (own, 0, rows.data_ptr(), R),
                 (blab.data.data_ptr(), *march, C, ch.data_ptr()))
        out = [*fwds, val, arg, ch]
        for mip in (0, 1):
            fused, farg = _out(8, R), _out(R, dtype=torch.int32)
            assert _on_copy(ftwin, "ft_joseph", copy, axis, (_OWN, mip, rows.data_ptr(), R),
                            (*march, fused.data_ptr(), farg.data_ptr())) == 0
            out += [fused] + ([farg] if mip else [])
        bwd, bwd_mip, bwd_ch = _out(7, R), _out(7, R), _out(7, R)
        _on_copy(ftwin, "ft_joseph_bwd_rays", copy, axis, (_OWN, rows.data_ptr(), R),
                 (*march, g.data_ptr(), bwd.data_ptr()))
        _on_copy(ftwin, "ft_joseph_bwd_rays_mip", copy, axis, (rows.data_ptr(), R),
                 (*march, g.data_ptr(), arg.data_ptr(), bwd_mip.data_ptr()))
        _on_copy(ftwin, "ft_joseph_ch", copy, axis, (_OWN, rows.data_ptr(), R),
                 (blab.data.data_ptr(), *march, C, gc.data_ptr(), bwd_ch.data_ptr()))
        res[copy.storage] = out + [bwd, bwd_mip, bwd_ch]
    names = [f"fwd unroll {u}" for u in _UNROLLS] + [
        "max", "argmax", "fwd_ch", "fwdgrad", "fwdgrad_max", "fwdgrad_argmax", "bwd_rays",
        "bwd_rays_mip", "bwd_rays_ch"]
    for name, a, b in zip(names, res["bf16"], res[None]):
        assert torch.equal(_bits(a), _bits(b)), name
    for name, a in zip(names[1:len(_UNROLLS)], res["bf16"][1:len(_UNROLLS)]):
        assert torch.equal(_bits(a), _bits(res["bf16"][0])), name
    fwd, arg = res["bf16"][0], res["bf16"][len(_UNROLLS) + 1]
    _assert_reached(scene, fwd)
    assert (arg >= 0).sum() > _reached(scene)
    strided = _JosephTwin(jtwin, rows, _rounded(vol), axis, h, n).bwd_rays(g, arg)
    assert torch.equal(_bits(res["bf16"][-2]), _bits(strided))


def _variant_id(variant):
    return "G{}-U{}".format(*(x or "own" for x in _FUSED_VARIANTS[variant]))


_BF16_VARIANTS = pytest.mark.parametrize("variant", range(len(_FUSED_VARIANTS)), ids=_variant_id)


def _assert_fused_reached(scene, value):
    """The fused value row on a scene's rays: many finite positive sums,
    and for "special" non-finite ones from the density (an infinity read
    at a zero-length segment, whose value the crossings' terms take, makes
    the slab's value a NaN)."""
    assert (torch.isfinite(value) & (value > 0)).sum() > _reached(scene)
    if scene == "special":
        assert not torch.isfinite(value).all()


def _nan_bits(t):
    """``_bits`` with every NaN as one pattern. On the host a sum of two
    NaNs keeps its first operand's payload, and which operand of a
    commutative add comes first is the compiler's choice, which differs
    between the variants' code (a NaN of the density against the default
    NaN of 0 * inf); the card's arithmetic gives one canonical NaN. Every
    other value, zeros' signs and infinities included, keeps its bits."""
    return _bits(torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
                 if t.is_floating_point() else t)


def _assert_variant_bits(got, ref, own, names):
    """A bf16 variant's outputs ``got`` bit for bit the float32 twin's at
    the same variant on the rounded density (``ref``) and the kernels' own
    bf16 variant's (``own``), a NaN as a NaN (``_nan_bits``)."""
    for name, a, b, c in zip(names, got, ref, own):
        assert torch.equal(_nan_bits(a), _nan_bits(b)), f"{name} vs float32 on the rounded density"
        assert torch.equal(_nan_bits(a), _nan_bits(c)), f"{name} vs the kernel's own bf16 variant"


@_BF16_VARIANTS
@pytest.mark.parametrize("scene", ["random", "special"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_siddon_fused_bf16_variants_equal_f32_on_rounded(ftwin, ftwin_bf16, axis, scene,
                                                              variant):
    """siddon_fwdgrad's lanes and the two-pass backward's sum mode on a bf16
    copy (fused_terms' raw reads) at the variant's G lanes a ray and U slabs
    in flight a lane (G = 1, 2, 8, 32 at the kernel's U; U = 1, 2, 4 at its
    G; its own): bit for bit the float32 twin at the same variant on the
    copy of the density rounded to bf16, and the kernels' own bf16 variant,
    on every ray of ``_bf16_scene`` (-0.0, subnormals, +-inf and NaN in
    "special"); the backward's rows the fused rows times g, bit for bit."""
    rng = np.random.default_rng(330 + axis)
    vol, rows = _bf16_scene(scene, rng, axis)
    R = rows.shape[1]
    g = torch.tensor(rng.normal(size=R), dtype=torch.float32)
    bf, f32 = _copies(vol)

    def run(so, copy, v):
        fused, bwd = _out(10, R), _out(9, R)
        _on_copy(so, "ft_siddon", copy, axis, (v, rows.data_ptr(), R), (fused.data_ptr(),))
        _on_copy(so, "ft_siddon_bwd_rays", copy, axis, (v, rows.data_ptr(), R),
                 (g.data_ptr(), bwd.data_ptr()))
        return fused, bwd

    got = run(ftwin_bf16, bf, variant)
    _assert_variant_bits(got, run(ftwin, f32, variant), run(ftwin, bf, _OWN),
                         ("fwdgrad", "bwd_rays"))
    fused, bwd = got
    _assert_fused_reached(scene, fused[9])
    assert torch.equal(_nan_bits(bwd), _nan_bits(fused[:9] * g))


@_BF16_VARIANTS
@pytest.mark.parametrize("scene", ["random", "special"])
@pytest.mark.parametrize("h", [1.0, 1.37], ids=["h1", "h1.37"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_fused_bf16_variants_equal_f32_on_rounded(ftwin, ftwin_bf16, axis, h, scene,
                                                              variant):
    """joseph_fwdgrad's lanes (sum and max mode: rows, values and argmax
    steps) and the two-pass backward's sum mode on a bf16 copy (fused_terms'
    raw windows) at every variant, as the Siddon test above, at integer h
    and fractional h (blend mode: two planes a window)."""
    rng = np.random.default_rng(340 + axis)
    vol, rows = _bf16_scene(scene, rng, axis, quadrature="joseph", h=h)
    R = rows.shape[1]
    n = int(-(-vol.shape[axis] // h))
    march = (h, n, int(J.is_blend(h)))
    g = torch.tensor(rng.normal(size=R), dtype=torch.float32)
    bf, f32 = _copies(vol)

    def run(so, copy, v):
        out = []
        for mip in (0, 1):
            fused, arg = _out(8, R), _out(R, dtype=torch.int32)
            assert _on_copy(so, "ft_joseph", copy, axis, (v, mip, rows.data_ptr(), R),
                            (*march, fused.data_ptr(), arg.data_ptr())) == 0
            out += [fused] + ([arg] if mip else [])
        bwd = _out(7, R)
        _on_copy(so, "ft_joseph_bwd_rays", copy, axis, (v, rows.data_ptr(), R),
                 (*march, g.data_ptr(), bwd.data_ptr()))
        return out + [bwd]

    got = run(ftwin_bf16, bf, variant)
    _assert_variant_bits(got, run(ftwin, f32, variant), run(ftwin, bf, _OWN),
                         ("fwdgrad", "fwdgrad_max", "fwdgrad_argmax", "bwd_rays"))
    fused, _, arg, bwd = got
    _assert_fused_reached(scene, fused[7])
    assert (arg >= 0).sum() > _reached(scene)
    assert torch.equal(_nan_bits(bwd), _nan_bits(fused[:7] * g))


# (G, U) of the bf16 channel kernels' probes (G lanes a ray, U steps in
# flight a lane; None: the kernel's own), in ch_variant's order.
_CH_VARIANTS = ((4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (8, 4), (16, 1), (16, 2), (16, 4),
                (None, None))
_CH_VARIANT_SRC = r"""
#include <type_traits>
// f(G, U) of variant v of _CH_VARIANTS (0, 0 past them: the kernel's own).
template <class F>
static void ch_variant(int v, F f) {
  using std::integral_constant;
  switch (v) {
    case 0: f(integral_constant<int, 4>(), integral_constant<int, 1>()); break;
    case 1: f(integral_constant<int, 4>(), integral_constant<int, 2>()); break;
    case 2: f(integral_constant<int, 4>(), integral_constant<int, 4>()); break;
    case 3: f(integral_constant<int, 8>(), integral_constant<int, 1>()); break;
    case 4: f(integral_constant<int, 8>(), integral_constant<int, 2>()); break;
    case 5: f(integral_constant<int, 8>(), integral_constant<int, 4>()); break;
    case 6: f(integral_constant<int, 16>(), integral_constant<int, 1>()); break;
    case 7: f(integral_constant<int, 16>(), integral_constant<int, 2>()); break;
    case 8: f(integral_constant<int, 16>(), integral_constant<int, 4>()); break;
    default: f(integral_constant<int, 0>(), integral_constant<int, 0>()); break;
  }
}
"""


@pytest.fixture(scope="module")
def chtwin(tmp_path_factory):
    """The two channel twins' lane loops alone, on the float32 and the bf16
    copy at every variant of ``_CH_VARIANTS``: (joseph_fwd_ch's,
    ``bt_joseph_ch``; joseph_bwd_rays_ch's, ``ft_joseph_ch``), each a build
    of its twin's source with CH_VARIANTS."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    bvol = [ptr] + [i32] * 7
    fwd = _build_twin(tmp_path_factory, "chtwin_fwd", _CH_VARIANT_SRC + _BRICK_TWIN_SRC,
                      ("CH_VARIANTS",))
    bwd = _build_twin(tmp_path_factory, "chtwin_bwd", _CH_VARIANT_SRC + _FUSED_TWIN_SRC,
                      ("CH_VARIANTS",))
    for suffix in ("", "_bf16"):
        f = getattr(fwd, "bt_joseph_ch" + suffix)
        f.argtypes = [i32, i32, ptr, ctypes.c_int64] + bvol + [ptr, ctypes.c_float, i32, i32,
                                                               i32, ptr]
        f.restype = None
        b = getattr(bwd, "ft_joseph_ch" + suffix)
        b.argtypes = [i32, ptr, ctypes.c_int64] + bvol + [ptr, ctypes.c_float, i32, i32, i32,
                                                          ptr, ptr]
        b.restype = None
    return fwd, bwd


def _ch_variant_id(variant):
    return "G{}-U{}".format(*(x or "own" for x in _CH_VARIANTS[variant]))


@pytest.mark.parametrize("variant", range(len(_CH_VARIANTS)), ids=_ch_variant_id)
@pytest.mark.parametrize("scene", ["random", "special"])
@pytest.mark.parametrize("h", [1.0, 1.37, 0.5], ids=["h1", "h1.37", "h0.5"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_joseph_channel_bf16_variants_equal_f32_on_rounded(jtwin, chtwin, axis, h, scene,
                                                                variant):
    """joseph_fwd_ch's and joseph_bwd_rays_ch's lanes on a bf16 copy (the
    raw windows of channel_samples' and channel_terms' bf16 overloads) at the
    variant's G lanes a ray and U steps in flight a lane (every G and U the
    probes try, and the kernels' own): image and rows bit for bit the float32
    lanes' at the same variant on the copy of the density rounded to bf16,
    and the strided serial trace_fwd_ch and trace_bwd_rays_ch on the rounded
    density, a NaN as a NaN (``_nan_bits``); the forward also with its
    channels in tiles of 2. Labels -1..C (-1 and C drop), the labelmap's
    copy its int32 bits; integer h, a fractional h (blend mode: two planes a
    window) and h = 0.5, where every other step's lerp fraction is 0.5, the
    label's plane tie; every ray of ``_bf16_scene`` (-0.0, subnormals, +-inf
    and NaN in "special")."""
    rng = np.random.default_rng(350 + axis)
    vol, rows = _bf16_scene(scene, rng, axis, quadrature="joseph", h=h)
    dims = tuple(vol.shape)
    C = 3
    lab = torch.tensor(rng.integers(-1, C + 1, dims), dtype=torch.int32)
    R = rows.shape[1]
    n = int(-(-dims[axis] // h))
    march = (h, n, int(J.is_blend(h)))
    gc = torch.tensor(rng.normal(size=(C, R)), dtype=torch.float32)
    gc[:, :5] = 0.0  # rays of a zero cotangent
    blab = brick_density(lab)
    fwd_so, bwd_so = chtwin

    def run(copy, tile=0):
        img, rows7 = _out(C, R), _out(7, R)
        _on_copy(fwd_so, "bt_joseph_ch", copy, axis, (variant, tile, rows.data_ptr(), R),
                 (blab.data.data_ptr(), *march, C, img.data_ptr()))
        _on_copy(bwd_so, "ft_joseph_ch", copy, axis, (variant, rows.data_ptr(), R),
                 (blab.data.data_ptr(), *march, C, gc.data_ptr(), rows7.data_ptr()))
        return img, rows7

    bf, f32 = _copies(vol)
    got = run(bf)
    serial = _JosephTwin(jtwin, rows, _rounded(vol), axis, h, n)
    refs = {"float32 lanes": run(f32), "serial": (serial.fwd_ch(lab, C), serial.bwd_rays_ch(lab, gc))}
    refs["bf16 lanes, tiles of 2"] = (run(bf, 2)[0], got[1])
    for what, ref in refs.items():
        for name, a, b in zip(("fwd_ch", "bwd_rays_ch"), got, ref):
            assert torch.equal(_nan_bits(a), _nan_bits(b)), f"{name} vs {what}"
    img, rows7 = got
    assert (torch.isfinite(img) & (img > 0)).any(0).sum() > _reached(scene)
    assert (torch.isfinite(rows7) & (rows7 != 0)).any(0).sum() > _reached(scene) // 2


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(21, 23, 13), (130, 67, 133), (130, 68, 133), (9, 7, 133),
                                  (36, 40, 128), (6, 5, 1030)])
def test_cuda_brick_copy_bf16_matches_torch(dims):
    """brick_copy_bf16 on the card against its plain version on the card
    (torch's CUDA rounding), bit for bit, NaN bits too, on a density with
    ties, subnormals, values that round past the largest bf16, infinities
    and NaNs, in every layout of ``_copy_layouts``, on both paths, one
    launch a copy; its float32 path unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vol = _copy_values(np.random.default_rng(7), dims, "special")
    ref = brick_density_plain(vol.cuda(), "bf16").data.cpu()
    ref32 = brick_density_plain(vol).data
    copies = _cuda_copies(vol, "bf16")
    for name, (got, _) in copies.items():
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16)), name
    assert {packed for _, packed in copies.values()} == ({False} if dims[2] > 1024
                                                         else {False, True})
    for name, (got, _) in _cuda_copies(vol).items():
        _assert_copy_bits(got, ref32)
    clear_cache()


def _channel_bf16_cases(vol, rounded, lab, axis, h, rows, rng):
    """(bf16, float32 on the rounded density) pairs of joseph_fwd_ch and
    joseph_bwd_rays_ch at 3 channels (labels -1..3 in ``lab``: -1 and 3
    drop) at stride ``h`` over ``vol``'s extent along ``axis``."""
    n = int(-(-vol.shape[axis] // h))
    gc = torch.tensor(rng.normal(size=(3, rows.shape[1])), dtype=torch.float32, device="cuda")
    return [(J.joseph_fwd_ch(rows, vol, lab, axis, h, n, 3, "bf16"),
             J.joseph_fwd_ch(rows, rounded, lab, axis, h, n, 3)),
            (J.joseph_bwd_rays_ch(rows, vol, lab, axis, h, n, gc, "bf16"),
             J.joseph_bwd_rays_ch(rows, rounded, lab, axis, h, n, gc))]


def _fused_bf16_cases(vol, rounded, axis, h, rows):
    """(bf16, float32 on the rounded density) pairs of joseph_fwdgrad in
    sum mode (its rows) and in max mode (rows and argmax steps) at stride
    ``h`` over ``vol``'s extent along ``axis``."""
    n = int(-(-vol.shape[axis] // h))
    return [(J.joseph_fwdgrad(rows, vol, axis, h, n, "sum", "bf16")[0],
             J.joseph_fwdgrad(rows, rounded, axis, h, n)[0]),
            (J.joseph_fwdgrad(rows, vol, axis, h, n, "max", "bf16"),
             J.joseph_fwdgrad(rows, rounded, axis, h, n, "max"))]


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cuda_bf16_kernels_equal_f32_on_rounded(axis):
    """Every bf16 instantiation on the card against the float32 kernel on the
    density rounded to bf16, bit for bit (values, argmaxes, rows), and
    against its plain version on the finite rays (values 1e-4 of their
    largest, the float32 tests' tolerance); Joseph at integer and fractional
    h (1.37, and the lateral pose's 1.024 for the fused pose kernels and
    the channel kernels); every ray of ``_fwd_rays``, the NaN ray too. Along
    axis 0 also the fused pose kernels (sum and max) and the channel kernels
    at a lateral pose's depth: 512 slabs, Joseph at the trilinear stride
    h = 511 / 499 and at h = 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(320 + axis)
    dims = (70, 66, 40)
    vol = torch.tensor(rng.uniform(0.0, 1.0, dims), dtype=torch.float32, device="cuda")
    rounded = _rounded(vol)
    rows = _fwd_rays(rng, dims, axis).cuda()
    g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32, device="cuda")
    clear_cache()
    got_max = K.siddon_fwd_max(rows, vol, axis, "bf16")
    cases = [
        (K.siddon_fwd(rows, vol, axis, "bf16"), K.siddon_fwd(rows, rounded, axis)),
        (K.siddon_fwdgrad(rows, vol, axis, "bf16"), K.siddon_fwdgrad(rows, rounded, axis)),
        (got_max, K.siddon_fwd_max(rows, rounded, axis)),
        (K.siddon_bwd_rays(rows, vol, axis, g, None, "bf16"),
         K.siddon_bwd_rays(rows, rounded, axis, g)),
        (K.siddon_bwd_rays(rows, vol, axis, g, got_max[1], "bf16"),
         K.siddon_bwd_rays(rows, rounded, axis, g, got_max[1])),
    ]
    lab = torch.tensor(rng.integers(-1, 4, dims), dtype=torch.int32, device="cuda")
    for h in (1.0, 1.37):
        jr = _fwd_rays(rng, dims, axis, quadrature="joseph", h=h).cuda()
        n = int(-(-dims[axis] // h))
        jg = torch.tensor(rng.normal(size=jr.shape[1]), dtype=torch.float32, device="cuda")
        gc = torch.tensor(rng.normal(size=(3, jr.shape[1])), dtype=torch.float32, device="cuda")
        jmax = J.joseph_fwd_max(jr, vol, axis, h, n, "bf16")
        cases += [
            (J.joseph_fwd(jr, vol, axis, h, n, "bf16"), J.joseph_fwd(jr, rounded, axis, h, n)),
            (jmax, J.joseph_fwd_max(jr, rounded, axis, h, n)),
            (J.joseph_fwdgrad(jr, vol, axis, h, n, "sum", "bf16")[0],
             J.joseph_fwdgrad(jr, rounded, axis, h, n)[0]),
            (J.joseph_fwdgrad(jr, vol, axis, h, n, "max", "bf16"),
             J.joseph_fwdgrad(jr, rounded, axis, h, n, "max")),
            (J.joseph_bwd_rays(jr, vol, axis, h, n, jg, None, "bf16"),
             J.joseph_bwd_rays(jr, rounded, axis, h, n, jg)),
            (J.joseph_bwd_rays(jr, vol, axis, h, n, jg, jmax[1], "bf16"),
             J.joseph_bwd_rays(jr, rounded, axis, h, n, jg, jmax[1])),
            (J.joseph_fwd_ch(jr, vol, lab, axis, h, n, 3, "bf16"),
             J.joseph_fwd_ch(jr, rounded, lab, axis, h, n, 3)),
            (J.joseph_bwd_rays_ch(jr, vol, lab, axis, h, n, gc, "bf16"),
             J.joseph_bwd_rays_ch(jr, rounded, lab, axis, h, n, gc)),
        ]
        plain = J.joseph_fwd_plain(jr[:, :-1], vol, axis, h, n, "bf16")  # the finite rays
        np.testing.assert_allclose(cases[-8][0][:-1].cpu(), plain.cpu(),
                                   atol=1e-4 * plain.abs().max().item())
    cases += _fused_bf16_cases(vol, rounded, axis, 1.024, _fwd_rays(
        rng, dims, axis, quadrature="joseph", h=1.024).cuda())
    cases += _channel_bf16_cases(vol, rounded, lab, axis, 1.024, _fwd_rays(
        rng, dims, axis, quadrature="joseph", h=1.024).cuda(), rng)
    if axis == 0:  # a lateral pose's depth: 512 slabs
        deep = (512, 40, 36)
        vol_l = torch.tensor(rng.uniform(0.0, 1.0, deep), dtype=torch.float32, device="cuda")
        rounded_l = _rounded(vol_l)
        lab_l = torch.tensor(rng.integers(-1, 4, deep), dtype=torch.int32, device="cuda")
        rows_l = _fwd_rays(rng, deep, 0).cuda()
        got = K.siddon_fwdgrad(rows_l, vol_l, 0, "bf16")
        cases.append((got, K.siddon_fwdgrad(rows_l, rounded_l, 0)))
        _assert_fused_close(got[:, :-1].cpu(), K.siddon_fwdgrad_plain(
            rows_l[:, :-1], vol_l, 0, "bf16").cpu(), 9, "siddon_fwdgrad lateral")
        for h in (511 / 499, 1.0):
            jr = _fwd_rays(rng, deep, 0, quadrature="joseph", h=h).cuda()
            cases += _fused_bf16_cases(vol_l, rounded_l, 0, h, jr)
            plain, _ = J.joseph_fwdgrad_plain(jr[:, :-1], vol_l, 0, h, int(-(-512 // h)), "sum",
                                              "bf16")
            _assert_fused_close(cases[-2][0][:, :-1].cpu(), plain.cpu(), 7,
                                f"joseph_fwdgrad lateral h {h}")
            cases += _channel_bf16_cases(vol_l, rounded_l, lab_l, 0, h, jr, rng)
            plain = J.joseph_fwd_ch_plain(jr[:, :-1], vol_l, lab_l, 0, h, int(-(-512 // h)), 3,
                                          "bf16")
            np.testing.assert_allclose(cases[-2][0][:, :-1].cpu(), plain.cpu(),
                                       atol=1e-4 * plain.abs().max().item())
    torch.cuda.synchronize()
    for i, (got, ref) in enumerate(cases):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a), _bits(b)), i
    plain = K.siddon_fwd_plain(rows[:, :-1], vol, axis, "bf16")
    np.testing.assert_allclose(cases[0][0][:-1].cpu(), plain.cpu(),
                               atol=1e-4 * plain.abs().max().item())
