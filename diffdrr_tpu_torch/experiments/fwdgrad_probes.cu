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
//
// Built with -DPROBE_BF16, the file holds the bf16 probes instead
// (probe_siddon_fwdgrad_bf16 and probe_joseph_fwdgrad_bf16, below), on the
// density's bf16 bricked copy, at G = 4, 8 or 16 lanes a ray and U = 1, 2
// or 4 slabs (steps) in flight a lane:
//   variant 0 the package's fwdgrad_lanes (fused_terms' reads kept raw
//             until every one of the U slabs' (steps') loads has issued);
//           1 the parent's (each read widened where it lands: fused_terms
//             of the float32 copy over a volume whose voxel() is
//             brick::load, as the first bf16 build had it);
//           2 the raw loads only (per slab the three voxels around the
//             ray's position, per step its window's 4, 8 in blend mode,
//             U at a time, widened in the sums; the lanes' sums combined
//             by the tree below);
//           3 the march without loads (the float32 probe's kind 1 at the
//             same G and U: every offset computed, nothing read).
// probe_fwdgrad_bf16_attributes gives a variant's registers, local memory
// and static shared memory a thread or block, and its resident blocks an
// SM (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor).
#include <cuda_runtime.h>

#include <type_traits>

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

#if !defined(PROBE_BF16)
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
#else  // PROBE_BF16
using brick::bf16;
using BV = brick::Volume<A, bf16>;

// The bf16 copy as the first bf16 build read it: voxel() of the float32
// code, each read widened where it lands (siddon::voxel and joseph::voxel
// on a brick::Volume, brick::load). Over such a volume fused_terms is the
// float32 copy's, as that build had it.
struct SiddonWidened {
  BV b;
  int X, Y, Z;
};
struct JosephWidened {
  BV b;
  int X, Y, Z;
};

__host__ __device__ __forceinline__ float voxel(const SiddonWidened& v, int s, float fy,
                                                float fz) {
  return siddon::voxel(v.b, s, fy, fz);
}

__host__ __device__ __forceinline__ float voxel(const JosephWidened& v, int k, float fy,
                                                float fz) {
  return joseph::voxel(v.b, k, fy, fz);
}

// The volume variant V reads, W the family's widened copy: the bf16 copy
// (0, 2), W (1), or NoLoad over the copy's geometry (3: the offsets are the
// same in elements; nothing is read), made on the host so that NoLoad's
// zero is a kernel argument.
template <int V, class W>
using VolOf = std::conditional_t<V == 1, W, std::conditional_t<V == 3, NoLoad, BV>>;

template <int V, class W>
VolOf<V, W> volume_of(const BV& b) {
  if constexpr (V == 1) {
    return W{b, b.X, b.Y, b.Z};
  } else if constexpr (V == 3) {
    return no_load(brick::make_volume<A>(static_cast<const float*>(nullptr), b.bs_s, b.bs_y,
                                         b.bs_z, b.X, b.Y, b.Z));
  } else {
    return b;
  }
}

// The raw loads only, Siddon: lane j of ray t / G takes slabs lo + j,
// lo + j + G, ..., U at a time, each the three voxels at the ray's
// position in the slab (rounded, as the segments' 2x2 picks them) loaded
// raw before any is widened; the lanes' sums meet in the tree.
template <int G, int U>
__device__ __forceinline__ void siddon_loads_raw(const float* __restrict__ rows, int64_t n,
                                                 const BV& v, float* __restrict__ out) {
  int64_t t = thread_index();
  int64_t r = t / G;
  int lane = (int)(t % G);
  float acc[1] = {0.f};
  if (r < n) {
    siddon::Ray ray = siddon::load_ray(rows, n, r);
    int lo, hi;
    siddon::slab_range(ray, v.X, &lo, &hi);
    for (int s0 = lo + lane; s0 < hi; s0 += G * U) {
      bf16 raw[U][3];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int s = s0 + u * G;
        float alpha = (float)s * ray.a + ray.b;
        float fy = rintf(ray.gy + alpha * ray.dy);
        float fz = rintf(ray.gz + alpha * ray.dz);
        bool ok = s < hi;
        raw[u][0] = ok ? siddon::voxel_raw(v, s, fy, fz) : (bf16)0;
        raw[u][1] = ok ? siddon::voxel_raw(v, s, fy + 1.f, fz) : (bf16)0;
        raw[u][2] = ok ? siddon::voxel_raw(v, s, fy + 1.f, fz + 1.f) : (bf16)0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        acc[0] += (brick::widen(raw[u][0]) + brick::widen(raw[u][1])) + brick::widen(raw[u][2]);
    }
  }
  tree_sum<G, 1>(acc);
  if (r < n && lane == 0) out[r] = acc[0];
}

// The raw loads only, Joseph: lane j's steps lo + j, lo + j + G, ..., U at
// a time, each its window (window_raw at the step's plane and position:
// 4 loads, 8 in blend mode) loaded raw before any is widened.
template <int G, int U>
__device__ __forceinline__ void joseph_loads_raw(const float* __restrict__ rows, int64_t n,
                                                 const BV& v, const joseph::March& m,
                                                 float* __restrict__ out) {
  int64_t t = thread_index();
  int64_t r = t / G;
  int lane = (int)(t % G);
  float acc[1] = {0.f};
  if (r < n) {
    joseph::Ray ray = joseph::load_ray(rows, n, r);
    int lo, hi;
    joseph::step_range(ray, m, &lo, &hi);
    for (int p0 = lo + lane; p0 < hi; p0 += G * U) {
      bf16 raw[U][2][2][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int p = p0 + u * G;
        joseph::Step st;
        st.k = (float)p * m.h;
        float alpha = st.k * ray.a + ray.b;
        st.k0 = (int)st.k;
        st.fy = floorf(ray.gy + alpha * ray.dy);
        st.fz = floorf(ray.gz + alpha * ray.dz);
        joseph::window_raw(v, st, m.blend, p < hi, raw[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          acc[0] += (brick::widen(raw[u][q][0][0]) + brick::widen(raw[u][q][0][1])) +
                    (brick::widen(raw[u][q][1][0]) + brick::widen(raw[u][q][1][1]));
    }
  }
  tree_sum<G, 1>(acc);
  if (r < n && lane == 0) out[r] = acc[0];
}

// One kernel a variant V (the numbering at the top), so each has SASS of
// its own, on the volume VolOf<V, ...> (volume_of).
template <int V, int G, int U>
__global__ void __launch_bounds__(kThreads)
siddon_fwdgrad_bf16(const float* __restrict__ rows, int64_t n, VolOf<V, SiddonWidened> v,
                    float* __restrict__ out) {
  if constexpr (V == 2) {
    siddon_loads_raw<G, U>(rows, n, v, out);
  } else {
    siddon::fwdgrad_lanes<G, U>(rows, n, v, out, thread_index());
  }
}

template <int V, int G, int U>
__global__ void __launch_bounds__(kThreads)
joseph_fwdgrad_bf16(const float* __restrict__ rows, int64_t n, VolOf<V, JosephWidened> v,
                    joseph::March m, float* __restrict__ out, int* __restrict__ arg) {
  if constexpr (V == 2) {
    joseph_loads_raw<G, U>(rows, n, v, m, out);
  } else {
    joseph::fwdgrad_lanes<G, U>(rows, n, v, m, out, arg, thread_index());
  }
}

template <int N>
using IC = std::integral_constant<int, N>;

// f(IC<V>(), IC<G>(), IC<U>()) for variant 0..3, G 4, 8 or 16 and U 1, 2
// or 4; -1 for another.
template <int V, int G, class F>
int with_unroll(int unroll, F f) {
  switch (unroll) {
    case 1: return f(IC<V>(), IC<G>(), IC<1>());
    case 2: return f(IC<V>(), IC<G>(), IC<2>());
    case 4: return f(IC<V>(), IC<G>(), IC<4>());
    default: return -1;
  }
}

template <int V, class F>
int with_lanes(int n_lanes, int unroll, F f) {
  switch (n_lanes) {
    case 4: return with_unroll<V, 4>(unroll, f);
    case 8: return with_unroll<V, 8>(unroll, f);
    case 16: return with_unroll<V, 16>(unroll, f);
    default: return -1;
  }
}

template <class F>
int with_bf16_variant(int variant, int n_lanes, int unroll, F f) {
  switch (variant) {
    case 0: return with_lanes<0>(n_lanes, unroll, f);
    case 1: return with_lanes<1>(n_lanes, unroll, f);
    case 2: return with_lanes<2>(n_lanes, unroll, f);
    case 3: return with_lanes<3>(n_lanes, unroll, f);
    default: return -1;
  }
}

// What probe_fwdgrad_bf16_attributes reports of one kernel: its registers,
// local-memory bytes and static shared-memory bytes, and its resident
// blocks an SM at kThreads threads.
template <class K>
int attributes(K kernel, int* res) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[3], kernel, kThreads, 0);
  res[0] = a.numRegs;
  res[1] = (int)a.localSizeBytes;
  res[2] = (int)a.sharedSizeBytes;
  return (int)err;
}

}  // namespace probe

// The bf16 copy's arguments are those of siddon_fwdgrad_bf16 and
// joseph_fwdgrad_bf16: the march axis, then the (s, y, z) axes' brick
// strides and extents. Joseph's arg: NULL for sum mode, else the argmax
// steps (max mode; variants 0, 1 and 3).
extern "C" int probe_siddon_fwdgrad_bf16(int variant, int n_lanes, int unroll,
                                         const float* rows, int64_t n, const brick::bf16* bricked,
                                         int axis, int bs_s, int bs_y, int bs_z, int X, int Y,
                                         int Z, float* out, void* stream) {
  if (axis != probe::A) return -2;
  if (n <= 0) return 0;
  probe::BV v = brick::make_volume<probe::A>(bricked, bs_s, bs_y, bs_z, X, Y, Z);
  int rc = probe::with_bf16_variant(variant, n_lanes, unroll, [&](auto var, auto g, auto u) {
    constexpr int V = decltype(var)::value, G = decltype(g)::value;
    probe::siddon_fwdgrad_bf16<V, G, decltype(u)::value>
        <<<probe::n_blocks(n * G), probe::kThreads, 0, (cudaStream_t)stream>>>(
            rows, n, probe::volume_of<V, probe::SiddonWidened>(v), out);
    return 0;
  });
  return rc != 0 ? rc : (int)cudaGetLastError();
}

extern "C" int probe_joseph_fwdgrad_bf16(int variant, int n_lanes, int unroll, const float* rows,
                                         int64_t n, const brick::bf16* bricked, int axis,
                                         int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                                         float h, int n_steps, int blend, float* out, int* arg,
                                         void* stream) {
  if (axis != probe::A) return -2;
  if (n <= 0) return 0;
  if (variant == 2 && arg != nullptr) return -1;
  probe::BV v = brick::make_volume<probe::A>(bricked, bs_s, bs_y, bs_z, X, Y, Z);
  joseph::March m;
  m.h = h;
  m.n_steps = n_steps;
  m.blend = blend != 0;
  int rc = probe::with_bf16_variant(variant, n_lanes, unroll, [&](auto var, auto g, auto u) {
    constexpr int V = decltype(var)::value, G = decltype(g)::value;
    probe::joseph_fwdgrad_bf16<V, G, decltype(u)::value>
        <<<probe::n_blocks(n * G), probe::kThreads, 0, (cudaStream_t)stream>>>(
            rows, n, probe::volume_of<V, probe::JosephWidened>(v), m, out, arg);
    return 0;
  });
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// res[0..3]: registers a thread, local-memory bytes a thread, static
// shared-memory bytes a block, resident blocks an SM, of family 0 (Siddon)
// or 1 (Joseph) at the variant, G and U.
extern "C" int probe_fwdgrad_bf16_attributes(int family, int variant, int n_lanes, int unroll,
                                             int* res) {
  return probe::with_bf16_variant(variant, n_lanes, unroll, [&](auto var, auto g, auto u) {
    constexpr int V = decltype(var)::value, G = decltype(g)::value, U = decltype(u)::value;
    return family == 0 ? probe::attributes(probe::siddon_fwdgrad_bf16<V, G, U>, res)
                       : probe::attributes(probe::joseph_fwdgrad_bf16<V, G, U>, res);
  });
}
#endif  // PROBE_BF16
