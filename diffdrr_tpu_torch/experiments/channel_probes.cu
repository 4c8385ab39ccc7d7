// Probe kernels of diffdrr_tpu_torch/experiments/channel_timing.py (sm_90a):
// variants of the two channel backwards, joseph_bwd_rays_ch and
// joseph_bwd_vol_ch, built from the package's headers, to see what bounds
// them. channel_timing.py compiles this file with the package's nvcc flags
// and -I diffdrr_tpu_torch/csrc, once for each march axis it probes
// (-DPROBE_AXIS=A: the bricked variants are templates on it); the package
// never loads it.
//
// probe_bwd_rays_ch takes the density twice, strided (its own layout) and
// bricked (brick.cuh), the labelmap twice, strided and bricked (brick_copy
// of its int32 bits seen as float32, so the same brick strides), and:
//   kind    0 the lanes (bwd_rays_ch_lanes in joseph.cuh: the package's
//             kernel at its own G and U with both layouts bricked); 1 the
//             march without loads (both bricked copies' offsets computed,
//             nothing read: every label 0, so the cotangent gather stays);
//             3 the parent kernel, one thread per ray on the strided
//             density and labelmap (the serial trace_bwd_rays_ch: what the
//             package launched before the lanes);
//   layout  the density's: 0 strided, 1 bricked;
//   labels  the labelmap's: 0 strided, 1 bricked (kind 0: both strided,
//           both bricked, or the density bricked and the labels strided);
//   n_lanes G: 1, 2, 4, 8, 16 or 32;
//   unroll  U: 1, 2 or 4 (U > 1 only for kind 0, both bricked).
// probe_bwd_vol_ch: kind 3 the parent scatter, one thread per ray (the
// serial trace_bwd_vol_ch, atomics on the device); kind 1 the package's
// warp per ray without its scatter: the same step_adds_ch_at calls, their
// adds summed in each lane and one sum a ray written to out (R,), no
// shared memory and no atomics.
// 128 threads a block, as in the kernels. Each returns cudaGetLastError(),
// or -1 for a combination it does not build (-2: another march axis than
// this build's).
#include <cuda_runtime.h>

#include "joseph.cuh"

#ifndef PROBE_AXIS
#define PROBE_AXIS 2
#endif

namespace probe {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int A = PROBE_AXIS;
static_assert(kThreads == joseph::kFusedThreads,
              "bwd_rays_ch_lanes' hand-over is sized for blocks of kFusedThreads");

unsigned int n_blocks(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

__device__ __forceinline__ int64_t thread_index() {
  return (int64_t)blockIdx.x * kThreads + threadIdx.x;
}

using BrickLabels = joseph::BrickLabels<A>;

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

// The bricked labelmap likewise: every label 0.
struct NoLoadLabels {
  brick::Volume<A> b;
  int zero;
  int X, Y, Z;
};

__host__ __device__ __forceinline__ int label_voxel(const NoLoadLabels& l, int k, float ry,
                                                    float rz) {
  return (int)brick::offset(l.b, k, (int)ry, (int)rz) & l.zero;
}

template <int G, int U, class Vol, class Lab>
__global__ void __launch_bounds__(kThreads)
rays_lanes(const float* __restrict__ rows, int64_t n, Vol v, Lab l, joseph::March m, int C,
           const float* __restrict__ g, float* __restrict__ out) {
  joseph::bwd_rays_ch_lanes<G, U>(rows, n, v, l, m, C, g, out, thread_index());
}

// The parent kernels, one thread per ray.
__global__ void __launch_bounds__(kThreads)
rays_parent(const float* __restrict__ rows, int64_t n, joseph::Volume v, joseph::Labels l,
            joseph::March m, int C, const float* __restrict__ g, float* __restrict__ out) {
  int64_t r = thread_index();
  if (r >= n) return;
  float acc[joseph::kRows];
  joseph::trace_bwd_rays_ch(joseph::load_ray(rows, n, r), v, l, m, C, g + r, n, acc);
#pragma unroll
  for (int i = 0; i < joseph::kRows; ++i) out[i * n + r] = acc[i];
}

__global__ void __launch_bounds__(kThreads)
vol_parent(const float* __restrict__ rows, int64_t n, joseph::Labels l, joseph::March m, int C,
           const float* __restrict__ g, joseph::GradVolume gv) {
  int64_t r = thread_index();
  if (r >= n) return;
  joseph::trace_bwd_vol_ch(joseph::load_ray(rows, n, r), gv, l, m, C, g + r, n);
}

// The warp per ray's march without its scatter (kind 1 above).
__global__ void __launch_bounds__(kThreads)
vol_march_only(const float* __restrict__ rows, int64_t n, joseph::Labels l, joseph::March m,
               int C, const float* __restrict__ g, joseph::GradVolume gv,
               float* __restrict__ out) {
  int64_t r = thread_index() / kWarp;
  int lane = threadIdx.x % kWarp;
  if (r >= n) return;
  joseph::Ray ray = joseph::load_ray(rows, n, r);
  int lo, hi;
  joseph::step_range(ray, m, &lo, &hi);
  float sum = 0.f;
  for (int p = lo + lane; p < hi; p += kWarp) {
    int64_t off[joseph::kStepAdds];
    float x[joseph::kStepAdds];
    unsigned mask = joseph::step_adds_ch_at(ray, gv, l, m, p, C, g + r, n, off, x);
#pragma unroll
    for (int q = 0; q < joseph::kStepAdds; ++q)
      if (mask >> q & 1u) sum += x[q] + (float)(off[q] & 1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) out[r] = sum;
}

#define PROBE_LANES(CALL, U)       \
  switch (n_lanes) {               \
    case 1: CALL(1, U); break;     \
    case 2: CALL(2, U); break;     \
    case 4: CALL(4, U); break;     \
    case 8: CALL(8, U); break;     \
    case 16: CALL(16, U); break;   \
    case 32: CALL(32, U); break;   \
    default: return -1;            \
  }

int rays_probe(int kind, int layout, int lab_layout, int n_lanes, int unroll,
               const float* rows, int64_t n, const joseph::Volume& sv,
               const brick::Volume<A>& bv, const joseph::Labels& sl, const BrickLabels& bl,
               joseph::March m, int C, const float* g, float* out, cudaStream_t st) {
  int64_t nt = n * n_lanes;
#define LANES(G, U) \
  rays_lanes<G, U><<<n_blocks(nt), kThreads, 0, st>>>(rows, n, VOL, LAB, m, C, g, out)
  if (kind == 3) {
    if (layout != 0 || lab_layout != 0 || unroll != 1) return -1;
    rays_parent<<<n_blocks(n), kThreads, 0, st>>>(rows, n, sv, sl, m, C, g, out);
  } else if (kind == 0 && layout == 1 && lab_layout == 1) {
#define VOL bv
#define LAB bl
    switch (unroll) {
      case 1: PROBE_LANES(LANES, 1) break;
      case 2: PROBE_LANES(LANES, 2) break;
      case 4: PROBE_LANES(LANES, 4) break;
      default: return -1;
    }
#undef VOL
#undef LAB
  } else if (unroll != 1) {
    return -1;
  } else if (kind == 0 && layout == 0 && lab_layout == 0) {
#define VOL sv
#define LAB sl
    PROBE_LANES(LANES, 1)
#undef VOL
#undef LAB
  } else if (kind == 0 && layout == 1 && lab_layout == 0) {
#define VOL bv
#define LAB sl
    PROBE_LANES(LANES, 1)
#undef VOL
#undef LAB
  } else if (kind == 1 && layout == 1 && lab_layout == 1) {
    NoLoad nv{bv, 0, bv.X, bv.Y, bv.Z};
    NoLoadLabels nl{bl, 0, bl.X, bl.Y, bl.Z};
#define VOL nv
#define LAB nl
    PROBE_LANES(LANES, 1)
#undef VOL
#undef LAB
  } else {
    return -1;
  }
#undef LANES
  return (int)cudaGetLastError();
}

joseph::March make_march(float h, int n_steps, int blend) {
  joseph::March m;
  m.h = h;
  m.n_steps = n_steps;
  m.blend = blend != 0;
  return m;
}

}  // namespace probe

// The bricked arguments are those of joseph_bwd_rays_ch: the march axis,
// then the (s, y, z) axes' brick strides and extents, which the labelmap's
// bricked copy shares (the same extents).
extern "C" int probe_bwd_rays_ch(int kind, int layout, int lab_layout, int n_lanes, int unroll,
                                 const float* rows, int64_t n, const float* strided, int64_t ss,
                                 int64_t sy, int64_t sz, const float* bricked, int axis,
                                 int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                                 const int* labels, int64_t ls, int64_t ly, int64_t lz,
                                 const float* blabels, float h, int n_steps, int blend, int C,
                                 const float* g, float* out, void* stream) {
  if (axis != probe::A) return -2;
  if (n <= 0) return 0;
  joseph::Volume sv{strided, ss, sy, sz, X, Y, Z};
  joseph::Labels sl{labels, ls, ly, lz, X, Y, Z};
  probe::BrickLabels bl{brick::make_volume<probe::A>(blabels, bs_s, bs_y, bs_z, X, Y, Z)};
  return probe::rays_probe(kind, layout, lab_layout, n_lanes, unroll, rows, n, sv,
                           brick::make_volume<probe::A>(bricked, bs_s, bs_y, bs_z, X, Y, Z), sl,
                           bl, probe::make_march(h, n_steps, blend), C, g, out,
                           (cudaStream_t)stream);
}

// grad: a zero-filled volume with the density's extents and its strides
// (gs, gy, gz) in march order; out: (n,) for kind 1.
extern "C" int probe_bwd_vol_ch(int kind, const float* rows, int64_t n, const int* labels,
                                int64_t ls, int64_t ly, int64_t lz, float* grad, int64_t gs,
                                int64_t gy, int64_t gz, int X, int Y, int Z, float h,
                                int n_steps, int blend, int C, const float* g, float* out,
                                void* stream) {
  if (n <= 0) return 0;
  joseph::Labels sl{labels, ls, ly, lz, X, Y, Z};
  joseph::GradVolume gv{grad, gs, gy, gz, X, Y, Z};
  joseph::March m = probe::make_march(h, n_steps, blend);
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 3) {
    probe::vol_parent<<<probe::n_blocks(n), probe::kThreads, 0, st>>>(rows, n, sl, m, C, g, gv);
  } else if (kind == 1) {
    probe::vol_march_only<<<probe::n_blocks(n * probe::kWarp), probe::kThreads, 0, st>>>(
        rows, n, sl, m, C, g, gv, out);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
