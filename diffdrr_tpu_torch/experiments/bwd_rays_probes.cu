// Probe kernels of diffdrr_tpu_torch/experiments/bwd_rays_timing.py
// (sm_90a): variants of joseph_bwd_rays, built from the package's headers,
// to see what bounds it. bwd_rays_timing.py compiles this file with the
// package's nvcc flags and -I diffdrr_tpu_torch/csrc, once for each march
// axis it probes (-DPROBE_AXIS=A: the bricked variants are templates on
// it); the package never loads it.
//
// The entry point takes the density twice, strided (its own layout) and
// bricked (brick.cuh). 128 threads a block, as in the kernels; each variant
// has G lanes a ray (n_lanes: 1, 2, 4, 8, 16 or 32) and U steps in flight a
// lane (unroll: 1, 2 or 4).
//
// probe_bwd_rays (arg NULL: sum mode, else MIP), kind:
//   0 one thread per ray, trace_bwd_rays (G = U = 1), layout 0 strided (the
//     parent kernel, either mode; in MIP the package's too) or 1 bricked;
//   1 the march without loads (bricked offsets computed, nothing read),
//     lanes as kind 5 (sum mode);
//   5 the package's sum-mode lanes (fwdgrad_lanes with N = 7 rows and the
//     product by g), layout 0 or 1 (the package's kernel: bricked at its own
//     G and U).
// It returns cudaGetLastError(), or -1 for a combination it does not build
// (-2: another march axis than this build's).
#include <cuda_runtime.h>

#include "joseph.cuh"

#ifndef PROBE_AXIS
#define PROBE_AXIS 2
#endif

namespace probe {

constexpr int kThreads = 128;
constexpr int A = PROBE_AXIS;
static_assert(kThreads == joseph::kFusedThreads,
              "fwdgrad_lanes' hand-over is sized for blocks of kFusedThreads");

unsigned int n_blocks(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

__device__ __forceinline__ int64_t thread_index() {
  return (int64_t)blockIdx.x * kThreads + threadIdx.x;
}

// The bricked density with each read replaced by its offset ANDed with a
// zero known only at run time: the address arithmetic stays, the load goes.
struct NoLoad {
  brick::Volume<A> b;
  int zero;
  int X, Y, Z;
};

__host__ __device__ __forceinline__ float voxel(const NoLoad& v, int k, float fy, float fz) {
  if (!(k >= 0 && k < v.X && fy >= 0.f && fy < (float)v.Y && fz >= 0.f && fz < (float)v.Z))
    return 0.f;
  return (float)((int)brick::offset(v.b, k, (int)fy, (int)fz) & v.zero);
}

#define PROBE_UNROLL(CALL, G)   \
  switch (unroll) {             \
    case 1: CALL(G, 1); break;  \
    case 2: CALL(G, 2); break;  \
    case 4: CALL(G, 4); break;  \
    default: return -1;         \
  }

#define PROBE_LANES(CALL)                  \
  switch (n_lanes) {                       \
    case 1: PROBE_UNROLL(CALL, 1) break;   \
    case 2: PROBE_UNROLL(CALL, 2) break;   \
    case 4: PROBE_UNROLL(CALL, 4) break;   \
    case 8: PROBE_UNROLL(CALL, 8) break;   \
    case 16: PROBE_UNROLL(CALL, 16) break; \
    case 32: PROBE_UNROLL(CALL, 32) break; \
    default: return -1;                    \
  }

// The parent's kernel on the strided density (and, in the probes, on the
// copy): one thread per ray, the serial march.
template <class Vol>
__global__ void __launch_bounds__(kThreads)
bwd_rays_thread(const float* __restrict__ rows, int64_t n, Vol v, joseph::March m,
                const float* __restrict__ g, const int* __restrict__ arg,
                float* __restrict__ out) {
  int64_t r = thread_index();
  if (r >= n) return;
  float acc[joseph::kRows];
  joseph::trace_bwd_rays(joseph::load_ray(rows, n, r), v, m, g[r], arg ? arg[r] : -1,
                         arg != nullptr, acc);
#pragma unroll
  for (int i = 0; i < joseph::kRows; ++i) out[i * n + r] = acc[i];
}

template <int G, int U, class Vol>
__global__ void __launch_bounds__(kThreads)
bwd_rays_lanes(const float* __restrict__ rows, int64_t n, Vol v, joseph::March m,
               const float* __restrict__ g, float* __restrict__ out) {
  joseph::fwdgrad_lanes<G, U, joseph::kRows>(rows, n, v, m, out, nullptr, thread_index(), g);
}

int bwd_rays_probe(int kind, int layout, int n_lanes, int unroll, const float* rows, int64_t n,
                   const joseph::Volume& sv, const brick::Volume<A>& bv, joseph::March m,
                   const float* g, const int* arg, float* out, cudaStream_t st) {
#define LANES(G, U) \
  bwd_rays_lanes<G, U><<<n_blocks(n * G), kThreads, 0, st>>>(rows, n, VOL, m, g, out)
  if (kind == 0 && n_lanes == 1 && unroll == 1 && layout == 0) {
    bwd_rays_thread<<<n_blocks(n), kThreads, 0, st>>>(rows, n, sv, m, g, arg, out);
  } else if (kind == 0 && n_lanes == 1 && unroll == 1 && layout == 1) {
    bwd_rays_thread<<<n_blocks(n), kThreads, 0, st>>>(rows, n, bv, m, g, arg, out);
  } else if (arg != nullptr) {
    return -1;  // the lanes are sum mode only
  } else if (kind == 5 && layout == 0) {
#define VOL sv
    PROBE_LANES(LANES)
#undef VOL
  } else if (kind == 5 && layout == 1) {
#define VOL bv
    PROBE_LANES(LANES)
#undef VOL
  } else if (kind == 1 && layout == 1) {
    NoLoad nv{bv, 0, bv.X, bv.Y, bv.Z};
#define VOL nv
    PROBE_LANES(LANES)
#undef VOL
  } else {
    return -1;
  }
#undef LANES
  return (int)cudaGetLastError();
}

}  // namespace probe

// The bricked arguments are those of joseph_bwd_rays: the march axis, then
// the (s, y, z) axes' brick strides and extents; the march those of every
// Joseph kernel.
extern "C" int probe_bwd_rays(int kind, int layout, int n_lanes, int unroll, const float* rows,
                              int64_t n, const float* strided, int64_t ss, int64_t sy,
                              int64_t sz, const float* bricked, int axis, int bs_s, int bs_y,
                              int bs_z, int X, int Y, int Z, float h, int n_steps, int blend,
                              const float* g, const int* arg, float* out, void* stream) {
  if (axis != probe::A) return -2;
  if (n <= 0) return 0;
  joseph::Volume sv{strided, ss, sy, sz, X, Y, Z};
  joseph::March m;
  m.h = h;
  m.n_steps = n_steps;
  m.blend = blend != 0;
  return probe::bwd_rays_probe(kind, layout, n_lanes, unroll, rows, n, sv,
                               brick::make_volume<probe::A>(bricked, bs_s, bs_y, bs_z, X, Y, Z),
                               m, g, arg, out, (cudaStream_t)stream);
}
