// Probe kernels of diffdrr_tpu_torch/experiments/fwdgrad_timing.py (sm_90a):
// variants of siddon_fwdgrad and joseph_fwdgrad built from the same headers,
// to see what bounds the two fused pose kernels. fwdgrad_timing.py compiles
// this file with the package's nvcc flags and -I diffdrr_tpu_torch/csrc,
// once for each march axis it probes (-DPROBE_AXIS=A: the bricked variants
// are templates on it); the package never loads it.
//
// Each entry point takes the density twice, strided (its own layout) and
// bricked (brick.cuh, the package's brick shape), and four choices:
//   layout  0 strided, 1 bricked;
//   kind    0 the fused march, G lanes a ray and U slabs (steps) in flight
//             a lane (fwdgrad_lanes in the headers: the package's kernel at
//             its own G and U on the bricked layout); 1 the march without
//             loads (bricked: every offset computed, nothing read); 2 the
//             loads only (per slab or step of a lane's share, the voxels at
//             the ray's position there, none of the segment, tent or row
//             arithmetic: two voxels a Siddon slab, the four in-plane
//             neighbours a Joseph step at integer h; the lanes' sums
//             combined by the tree below); 3 the parent kernel, one thread
//             per ray on the strided density (the serial trace_fwdgrad: what
//             the package launched before the lanes); 4 (bricked, sum mode)
//             the design first tried: lane j sums its own slabs lo + j,
//             lo + j + G, ... and the ray's G partial sums meet in a tree
//             of shuffles, in another order than the serial march's;
//   n_lanes G: 1, 2, 4, 8, 16 or 32;
//   unroll  U: 1, 2 or 4 (1 only for the strided layout and kinds 1 to 4).
// 128 threads a block, as in the kernels. Each returns cudaGetLastError(),
// or -1 for a combination it does not build (-2: another march axis than
// this build's).
#include <cuda_runtime.h>

#include "joseph.cuh"
#include "siddon.cuh"

#ifndef PROBE_AXIS
#define PROBE_AXIS 2
#endif

namespace probe {

constexpr int kThreads = 128;
constexpr int A = PROBE_AXIS;
static_assert(kThreads == siddon::kFusedThreads && kThreads == joseph::kFusedThreads,
              "fwdgrad_lanes' hand-over is sized for blocks of kFusedThreads");

unsigned int n_blocks(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

// The bricked copy with each read replaced by its offset ANDed with a zero
// known only at run time: the address arithmetic stays, the load goes.
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

NoLoad no_load(const brick::Volume<A>& b) {
  NoLoad v;
  v.b = b;
  v.zero = 0;
  v.X = b.X;
  v.Y = b.Y;
  v.Z = b.Z;
  return v;
}

__device__ __forceinline__ int64_t thread_index() {
  return (int64_t)blockIdx.x * kThreads + threadIdx.x;
}

// The G lanes' partial sums of a ray met in a tree of shuffles: stage
// o = 1, 2, ..., G / 2 adds lane j ^ o's partial to lane j's.
template <int G, int N>
__device__ __forceinline__ void tree_sum(float acc[N]) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
}

// The parent kernels, one thread per ray on the strided density.
__global__ void __launch_bounds__(kThreads)
siddon_parent(const float* __restrict__ rows, int64_t n, siddon::Volume v,
              float* __restrict__ out) {
  int64_t r = thread_index();
  if (r >= n) return;
  float acc[siddon::kFusedRows];
  siddon::trace_fwdgrad(siddon::load_ray(rows, n, r), v, acc);
#pragma unroll
  for (int k = 0; k < siddon::kFusedRows; ++k) out[k * n + r] = acc[k];
}

__global__ void __launch_bounds__(kThreads)
joseph_parent(const float* __restrict__ rows, int64_t n, joseph::Volume v, joseph::March m,
              float* __restrict__ out, int* __restrict__ arg) {
  int64_t r = thread_index();
  if (r >= n) return;
  float acc[joseph::kFusedRows];
  joseph::trace_fwdgrad(joseph::load_ray(rows, n, r), v, m, arg != nullptr, acc,
                        arg ? arg + r : nullptr);
#pragma unroll
  for (int i = 0; i < joseph::kFusedRows; ++i) out[i * n + r] = acc[i];
}

template <int G, int U, class Vol>
__global__ void __launch_bounds__(kThreads)
siddon_fused(const float* __restrict__ rows, int64_t n, Vol v, float* __restrict__ out) {
  siddon::fwdgrad_lanes<G, U>(rows, n, v, out, thread_index());
}

template <int G, int U, class Vol>
__global__ void __launch_bounds__(kThreads)
joseph_fused(const float* __restrict__ rows, int64_t n, Vol v, joseph::March m,
             float* __restrict__ out, int* __restrict__ arg) {
  joseph::fwdgrad_lanes<G, U>(rows, n, v, m, out, arg, thread_index());
}

// Kind 4: a lane's own slabs (steps) summed, the partials met in a tree.
template <int G, class Vol>
__global__ void __launch_bounds__(kThreads)
siddon_tree(const float* __restrict__ rows, int64_t n, Vol v, float* __restrict__ out) {
  int64_t t = thread_index();
  int64_t r = t / G;
  int lane = (int)(t % G);
  float acc[siddon::kFusedRows] = {};
  if (r < n) {
    siddon::Ray ray = siddon::load_ray(rows, n, r);
    int lo, hi;
    siddon::slab_range(ray, v.X, &lo, &hi);
    for (int s = lo + lane; s < hi; s += G) {
      float tm[1][siddon::kFusedRows];
      siddon::fused_terms<1>(ray, v, s, G, hi, tm);
#pragma unroll
      for (int k = 0; k < siddon::kFusedRows; ++k) acc[k] += tm[0][k];
    }
  }
  tree_sum<G, siddon::kFusedRows>(acc);
  if (r >= n) return;
#pragma unroll
  for (int k = 0; k < siddon::kFusedRows; ++k)
    if (k % G == lane) out[k * n + r] = acc[k];
}

template <int G, class Vol>
__global__ void __launch_bounds__(kThreads)
joseph_tree(const float* __restrict__ rows, int64_t n, Vol v, joseph::March m,
            float* __restrict__ out) {
  int64_t t = thread_index();
  int64_t r = t / G;
  int lane = (int)(t % G);
  float acc[joseph::kFusedRows] = {};
  if (r < n) {
    joseph::Ray ray = joseph::load_ray(rows, n, r);
    int lo, hi;
    joseph::step_range(ray, m, &lo, &hi);
    for (int p = lo + lane; p < hi; p += G) {
      float tm[1][joseph::kFusedRows];
      joseph::fused_terms<1>(ray, v, m, p, G, hi, tm);
#pragma unroll
      for (int i = 0; i < joseph::kFusedRows; ++i) acc[i] += tm[0][i];
    }
  }
  tree_sum<G, joseph::kFusedRows>(acc);
  if (r >= n) return;
#pragma unroll
  for (int i = 0; i < joseph::kFusedRows; ++i)
    if (i % G == lane) out[i * n + r] = acc[i];
}

// The loads of a lane's share only, summed, then the lanes' sums combined.
template <int G, class Vol>
__global__ void __launch_bounds__(kThreads)
siddon_loads(const float* __restrict__ rows, int64_t n, Vol v, float* __restrict__ out) {
  using siddon::voxel;
  int64_t t = thread_index();
  int64_t r = t / G;
  int lane = (int)(t % G);
  float acc[1] = {0.f};
  if (r < n) {
    siddon::Ray ray = siddon::load_ray(rows, n, r);
    int lo, hi;
    siddon::slab_range(ray, v.X, &lo, &hi);
    for (int s = lo + lane; s < hi; s += G) {
      float alpha = (float)s * ray.a + ray.b;
      float fy = floorf(ray.gy + alpha * ray.dy);
      float fz = floorf(ray.gz + alpha * ray.dz);
      acc[0] += voxel(v, s, fy, fz) + voxel(v, s, fy + 1.f, fz + 1.f);
    }
  }
  tree_sum<G, 1>(acc);
  if (r < n && lane == 0) out[r] = acc[0];
}

template <int G, class Vol>
__global__ void __launch_bounds__(kThreads)
joseph_loads(const float* __restrict__ rows, int64_t n, Vol v, joseph::March m,
             float* __restrict__ out) {
  using joseph::voxel;
  int64_t t = thread_index();
  int64_t r = t / G;
  int lane = (int)(t % G);
  float acc[1] = {0.f};
  if (r < n) {
    joseph::Ray ray = joseph::load_ray(rows, n, r);
    int lo, hi;
    joseph::step_range(ray, m, &lo, &hi);
    int step = (int)rintf(m.h);
    for (int p = lo + lane; p < hi; p += G) {
      float alpha = (float)p * m.h * ray.a + ray.b;
      float fy = floorf(ray.gy + alpha * ray.dy);
      float fz = floorf(ray.gz + alpha * ray.dz);
      int k = p * step;
      acc[0] += (voxel(v, k, fy, fz) + voxel(v, k, fy, fz + 1.f)) +
                (voxel(v, k, fy + 1.f, fz) + voxel(v, k, fy + 1.f, fz + 1.f));
    }
  }
  tree_sum<G, 1>(acc);
  if (r < n && lane == 0) out[r] = acc[0];
}

#define PROBE_LANES(CALL, U)  \
  switch (n_lanes) {          \
    case 1: CALL(1, U); break;   \
    case 2: CALL(2, U); break;   \
    case 4: CALL(4, U); break;   \
    case 8: CALL(8, U); break;   \
    case 16: CALL(16, U); break; \
    case 32: CALL(32, U); break; \
    default: return -1;          \
  }

#define PROBE_UNROLL(CALL)                     \
  switch (unroll) {                            \
    case 1: PROBE_LANES(CALL, 1) break;        \
    case 2: PROBE_LANES(CALL, 2) break;        \
    case 4: PROBE_LANES(CALL, 4) break;        \
    default: return -1;                        \
  }

int siddon_probe(int layout, int kind, int n_lanes, int unroll, const float* rows, int64_t n,
                 const siddon::Volume& sv, const brick::Volume<A>& bv, float* out,
                 cudaStream_t st) {
  int64_t nt = n * n_lanes;
#define S_FUSED(G, U) siddon_fused<G, U><<<n_blocks(nt), kThreads, 0, st>>>(rows, n, VOL, out)
#define S_LOADS(G, U) siddon_loads<G><<<n_blocks(nt), kThreads, 0, st>>>(rows, n, VOL, out)
#define S_TREE(G, U) siddon_tree<G><<<n_blocks(nt), kThreads, 0, st>>>(rows, n, VOL, out)
  if (kind == 3) {
    if (layout != 0) return -1;
    siddon_parent<<<n_blocks(n), kThreads, 0, st>>>(rows, n, sv, out);
  } else if (kind == 0 && layout == 1) {
#define VOL bv
    PROBE_UNROLL(S_FUSED)
#undef VOL
  } else if (unroll != 1) {
    return -1;
  } else if (kind == 0) {
#define VOL sv
    PROBE_LANES(S_FUSED, 1)
#undef VOL
  } else if (kind == 1 && layout == 1) {
    NoLoad nl = no_load(bv);
#define VOL nl
    PROBE_LANES(S_FUSED, 1)
#undef VOL
  } else if (kind == 2 && layout == 0) {
#define VOL sv
    PROBE_LANES(S_LOADS, 1)
#undef VOL
  } else if (kind == 2 && layout == 1) {
#define VOL bv
    PROBE_LANES(S_LOADS, 1)
#undef VOL
  } else if (kind == 4 && layout == 1) {
#define VOL bv
    PROBE_LANES(S_TREE, 1)
#undef VOL
  } else {
    return -1;
  }
#undef S_FUSED
#undef S_LOADS
#undef S_TREE
  return (int)cudaGetLastError();
}

int joseph_probe(int layout, int kind, int n_lanes, int unroll, const float* rows, int64_t n,
                 const joseph::Volume& jv, const brick::Volume<A>& bv, joseph::March m,
                 float* out, int* arg, cudaStream_t st) {
  int64_t nt = n * n_lanes;
#define J_FUSED(G, U) \
  joseph_fused<G, U><<<n_blocks(nt), kThreads, 0, st>>>(rows, n, VOL, m, out, arg)
#define J_LOADS(G, U) joseph_loads<G><<<n_blocks(nt), kThreads, 0, st>>>(rows, n, VOL, m, out)
#define J_TREE(G, U) joseph_tree<G><<<n_blocks(nt), kThreads, 0, st>>>(rows, n, VOL, m, out)
  if (kind == 3) {
    if (layout != 0) return -1;
    joseph_parent<<<n_blocks(n), kThreads, 0, st>>>(rows, n, jv, m, out, arg);
  } else if (kind == 0 && layout == 1) {
#define VOL bv
    PROBE_UNROLL(J_FUSED)
#undef VOL
  } else if (unroll != 1) {
    return -1;
  } else if (kind == 0) {
#define VOL jv
    PROBE_LANES(J_FUSED, 1)
#undef VOL
  } else if (kind == 1 && layout == 1) {
    NoLoad nl = no_load(bv);
#define VOL nl
    PROBE_LANES(J_FUSED, 1)
#undef VOL
  } else if (kind == 2 && !m.blend) {
    if (layout == 0) {
#define VOL jv
      PROBE_LANES(J_LOADS, 1)
#undef VOL
    } else {
#define VOL bv
      PROBE_LANES(J_LOADS, 1)
#undef VOL
    }
  } else if (kind == 4 && layout == 1 && arg == nullptr) {
#define VOL bv
    PROBE_LANES(J_TREE, 1)
#undef VOL
  } else {
    return -1;
  }
#undef J_FUSED
#undef J_LOADS
#undef J_TREE
  return (int)cudaGetLastError();
}

}  // namespace probe

// The bricked arguments are those of siddon_fwdgrad and joseph_fwdgrad: the
// march axis, then the (s, y, z) axes' brick strides and extents.
extern "C" int probe_siddon_fwdgrad(int layout, int kind, int n_lanes, int unroll,
                                    const float* rows, int64_t n, const float* strided,
                                    int64_t ss, int64_t sy, int64_t sz, const float* bricked,
                                    int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                                    float* out, void* stream) {
  if (axis != probe::A) return -2;
  if (n <= 0) return 0;
  siddon::Volume sv{strided, ss, sy, sz, X, Y, Z};
  return probe::siddon_probe(layout, kind, n_lanes, unroll, rows, n, sv,
                             brick::make_volume<probe::A>(bricked, bs_s, bs_y, bs_z, X, Y, Z),
                             out, (cudaStream_t)stream);
}

extern "C" int probe_joseph_fwdgrad(int layout, int kind, int n_lanes, int unroll,
                                    const float* rows, int64_t n, const float* strided,
                                    int64_t ss, int64_t sy, int64_t sz, const float* bricked,
                                    int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                                    float h, int n_steps, int blend, float* out, int* arg,
                                    void* stream) {
  if (axis != probe::A) return -2;
  if (n <= 0) return 0;
  joseph::March m;
  m.h = h;
  m.n_steps = n_steps;
  m.blend = blend != 0;
  joseph::Volume jv{strided, ss, sy, sz, X, Y, Z};
  return probe::joseph_probe(layout, kind, n_lanes, unroll, rows, n, jv,
                             brick::make_volume<probe::A>(bricked, bs_s, bs_y, bs_z, X, Y, Z), m,
                             out, arg, (cudaStream_t)stream);
}
