// CUDA kernels for the Joseph plane march and the trilinear ray march (sm_90a).
//
// They replace the TPU kernels of diffdrr_tpu/ops/pallas/joseph.py, which
// also carry the trilinear renderer (ops/pallas/raymarch.py maps n_points to
// a fractional stride h):
//   joseph_fwd      _fwd_kernel, sum mode, and _fwd_plane_major_kernel (the
//                   same function, streamed plane by plane on the TPU);
//   joseph_fwd_max  _fwd_kernel, max mode: the MIP value and its argmax step;
//   joseph_fwdgrad  _fwdgrad_kernel: one march that emits the value and the 7
//                   cotangent-free gradient rows (under max: those of the
//                   argmax step), so the pose backward is rows * g;
//   joseph_bwd_rays _bwd_rays_kernel: the two-pass pose backward, sum or MIP;
//   joseph_bwd_vol  _bwd_vol_kernel: the density gradient, sum or MIP.
// Each takes integer and fractional h. Channel mode (mask_to_channels) is
// not ported yet.
//
// Design: one thread per ray, walking only its own in-slab steps (step_range
// in joseph.cuh) and reading the 4 in-plane neighbours of each sample (8 at
// fractional h) straight from the float32 density through its strides. The
// TPU needed tile windows, a starts table, a lane roll and tent-weight
// matmuls on the MXU to avoid gathers; on the H100 a gather is a load, so
// none of that is carried over, and with no window there is no footprint to
// overflow.
//
// What bounds them: per ray and in-slab step, 4 (or 8) 4-byte gathers at
// data-dependent addresses and about 35 float operations for a value, about
// 90 for the gradient rows. The bytes a render must move are the voxels its
// rays touch (at most the volume: 139 MB for the 512x512x133 CT) plus 36
// bytes of rows in and 4 to 32 bytes out per ray, tens of microseconds at
// 3.35 TB/s. The simple design is bound instead by the latency of dependent
// gathers: a warp's 32 rays are neighbouring detector pixels that read
// neighbouring voxels of the same plane at the same step, so L1/L2 serve
// most reads, but a 200x200 detector gives only 40,000 threads. The scatter
// (joseph_bwd_vol) adds 4 (or 8) float atomics per ray and step into the
// zero-filled gradient; their order changes from run to run, so its last
// bits do too. Shared-memory staging of plane windows is later work
// (PERF.md).
#include <cuda_runtime.h>

#include "joseph.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
joseph_fwd_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::Volume vol,
                  joseph::March m, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  out[r] = joseph::trace_fwd(joseph::load_ray(rows, n_rays, r), vol, m);
}

__global__ void __launch_bounds__(kThreads)
joseph_fwd_max_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::Volume vol,
                      joseph::March m, float* __restrict__ out, int* __restrict__ arg) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  joseph::trace_fwd_max(joseph::load_ray(rows, n_rays, r), vol, m, out + r, arg + r);
}

// arg == nullptr: sum mode; else MIP, the argmax step written to arg[r].
__global__ void __launch_bounds__(kThreads)
joseph_fwdgrad_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::Volume vol,
                      joseph::March m, float* __restrict__ out, int* __restrict__ arg) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  float acc[joseph::kFusedRows];
  joseph::trace_fwdgrad(joseph::load_ray(rows, n_rays, r), vol, m, arg != nullptr, acc,
                        arg ? arg + r : nullptr);
#pragma unroll
  for (int i = 0; i < joseph::kFusedRows; ++i) out[i * n_rays + r] = acc[i];
}

// arg == nullptr: sum mode; else MIP, gated to the step arg[r].
__global__ void __launch_bounds__(kThreads)
joseph_bwd_rays_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::Volume vol,
                       joseph::March m, const float* __restrict__ g,
                       const int* __restrict__ arg, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  float acc[joseph::kRows];
  joseph::trace_bwd_rays(joseph::load_ray(rows, n_rays, r), vol, m, g[r], arg ? arg[r] : -1,
                         arg != nullptr, acc);
#pragma unroll
  for (int i = 0; i < joseph::kRows; ++i) out[i * n_rays + r] = acc[i];
}

__global__ void __launch_bounds__(kThreads)
joseph_bwd_vol_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::March m,
                      const float* __restrict__ g, const int* __restrict__ arg,
                      joseph::GradVolume grad) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  joseph::trace_bwd_vol(joseph::load_ray(rows, n_rays, r), grad, m, g[r], arg ? arg[r] : -1,
                        arg != nullptr);
}

joseph::Volume make_volume(const float* vol, int64_t ss, int64_t sy, int64_t sz, int X, int Y,
                           int Z) {
  joseph::Volume v;
  v.data = vol;
  v.ss = ss;
  v.sy = sy;
  v.sz = sz;
  v.X = X;
  v.Y = Y;
  v.Z = Z;
  return v;
}

joseph::March make_march(float h, int n_steps, int blend) {
  joseph::March m;
  m.h = h;
  m.n_steps = n_steps;
  m.blend = blend != 0;
  return m;
}

unsigned int n_blocks(int64_t n_rays) { return (unsigned int)((n_rays + kThreads - 1) / kThreads); }

}  // namespace

// Plain C interface (loaded with ctypes). rows: (9, n_rays) float32; vol: the
// density with element strides (ss, sy, sz) of the march-permuted axes and
// extents (X, Y, Z); the march: n_steps samples at k = p * h, blend != 0 for
// a fractional h (h is the float32 rounding of the caller's stride); out:
// (n_rays,) for joseph_fwd, (n_rays,) values and (n_rays,) int32 steps for
// joseph_fwd_max, (8, n_rays) for joseph_fwdgrad, (7, n_rays) for
// joseph_bwd_rays; g: (n_rays,) float32; arg: (n_rays,) int32 argmax steps
// for MIP, or NULL for sum mode (joseph_fwdgrad writes it); grad: a
// zero-filled float32 volume with the density's extents and its own strides
// (gs, gy, gz) in the same permuted order. Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
extern "C" int joseph_fwd(const float* rows, int64_t n_rays, const float* vol, int64_t ss,
                          int64_t sy, int64_t sz, int X, int Y, int Z, float h, int n_steps,
                          int blend, float* out, void* stream) {
  if (n_rays > 0) {
    joseph_fwd_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z), make_march(h, n_steps, blend),
        out);
  }
  return (int)cudaGetLastError();
}

extern "C" int joseph_fwd_max(const float* rows, int64_t n_rays, const float* vol, int64_t ss,
                              int64_t sy, int64_t sz, int X, int Y, int Z, float h,
                              int n_steps, int blend, float* out, int* arg, void* stream) {
  if (n_rays > 0) {
    joseph_fwd_max_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z), make_march(h, n_steps, blend),
        out, arg);
  }
  return (int)cudaGetLastError();
}

extern "C" int joseph_fwdgrad(const float* rows, int64_t n_rays, const float* vol, int64_t ss,
                              int64_t sy, int64_t sz, int X, int Y, int Z, float h,
                              int n_steps, int blend, float* out, int* arg, void* stream) {
  if (n_rays > 0) {
    joseph_fwdgrad_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z), make_march(h, n_steps, blend),
        out, arg);
  }
  return (int)cudaGetLastError();
}

extern "C" int joseph_bwd_rays(const float* rows, int64_t n_rays, const float* vol, int64_t ss,
                               int64_t sy, int64_t sz, int X, int Y, int Z, float h,
                               int n_steps, int blend, const float* g, const int* arg,
                               float* out, void* stream) {
  if (n_rays > 0) {
    joseph_bwd_rays_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z), make_march(h, n_steps, blend), g,
        arg, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int joseph_bwd_vol(const float* rows, int64_t n_rays, const float* g, const int* arg,
                              float* grad, int64_t gs, int64_t gy, int64_t gz, int X, int Y,
                              int Z, float h, int n_steps, int blend, void* stream) {
  if (n_rays > 0) {
    joseph::GradVolume gv;
    gv.data = grad;
    gv.ss = gs;
    gv.sy = gy;
    gv.sz = gz;
    gv.X = X;
    gv.Y = Y;
    gv.Z = Z;
    joseph_bwd_vol_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_march(h, n_steps, blend), g, arg, gv);
  }
  return (int)cudaGetLastError();
}
