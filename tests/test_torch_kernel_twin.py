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
import shutil
import subprocess

import numpy as np
import pytest
import torch

from diffdrr_tpu_torch.ops.kernels import build
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


def _build_twin(tmp_path_factory, name, source):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available to build the host twin")
    d = tmp_path_factory.mktemp(name)
    src = d / f"{name}.cpp"
    src.write_text(source)
    lib = d / f"lib{name}.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{build.CSRC}", "-o", str(lib), str(src)],
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
    ``python -m pytest --noconftest tests/test_torch_kernel_twin.py -m gpu``)."""
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
