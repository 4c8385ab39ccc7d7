// Probe kernels of diffdrr_tpu_torch/experiments/max_channel_timing.py
// (sm_90a): variants of joseph_fwd_ch and siddon_fwd_max, built from the
// package's headers, to see what bounds them. max_channel_timing.py
// compiles this file with the package's nvcc flags and
// -I diffdrr_tpu_torch/csrc, once for each march axis it probes
// (-DPROBE_AXIS=A: the bricked variants are templates on it); the package
// never loads it.
//
// Both entry points take the density twice, strided (its own layout) and
// bricked (brick.cuh); probe_fwd_ch also the labelmap twice, strided and
// bricked (brick_copy of its int32 bits, so the density copy's brick
// strides). 128 threads a block, as in the kernels; each variant has G
// lanes a ray (n_lanes: 1, 2, 4, 8, 16 or 32) and U steps or slabs in
// flight a lane (unroll: 1, 2 or 4).
//
// probe_fwd_ch, kind:
//   0 the package's lanes (fwd_ch_lanes: the ray's sums in shared memory,
//     the last sample's in its lane 0's register), layout 0 strided
//     (density and labelmap) or 1 bricked (both; the package's kernel at
//     its own G and U); G = 1 is one thread per ray;
//   1 the march without loads (bricked offsets computed, nothing read:
//     every label 0), lanes as kind 0;
//   2 one thread per ray, bricked, the sums in global memory: a
//     read-modify-write of the ray's column of out at every sample (what
//     the parent kernel did), U steps' loads in flight;
//   3 as 2 with the sums in shared memory, read and written at every
//     sample (no register);
//   4 the parent kernel: trace_fwd_ch, one thread per ray, one step at a
//     time on the strided density and labelmap (layout 0, G = U = 1).
// probe_fwd_max, kind:
//   0 one thread per ray, trace_fwd_max<U>, layout 0 strided (U = 1: the
//     parent kernel) or 1 bricked;
//   1 the march without loads (bricked offsets computed, nothing read),
//     lanes as kind 5;
//   5 the package's lanes (fwd_max_lanes), layout 0 or 1 (the package's
//     kernel: bricked at its own G and U).
// Each returns cudaGetLastError(), or -1 for a combination it does not
// build (-2: another march axis than this build's).
//
// Built with -DPROBE_BF16, the file holds the bf16 probes instead
// (probe_fwd_ch_bf16 and probe_fwd_ch_bf16_attributes, below), on the density's
// bf16 bricked copy and the labelmap's copy (its int32 bits), at G = 4, 8
// or 16 lanes a ray and U = 1, 2 or 4 steps in flight a lane:
//   variant 0 the package's fwd_ch_lanes (channel_samples's bf16
//             overload: the U steps' windows loaded raw with their labels,
//             widened only once every load has issued);
//           1 the parent's (channel_samples of the float32 copy over a
//             volume whose voxel() is brick::load: each read widened, and
//             in blend mode lerped, where it lands, as the first bf16 build
//             had it);
//           2 the march without loads (the float32 probe's kind 1 at the
//             same G and U: every offset computed, nothing read, every
//             label 0).
// probe_fwd_ch_bf16_attributes gives a variant's registers, local memory
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

joseph::March make_march(float h, int n_steps, int blend) {
  joseph::March m;
  m.h = h;
  m.n_steps = n_steps;
  m.blend = blend != 0;
  return m;
}

#if !defined(PROBE_BF16)
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

// ---------------------------------------------------------------------------
// joseph_fwd_ch
// ---------------------------------------------------------------------------

// kind 0 and 1: C * (kThreads / G) floats of dynamic shared memory.
template <int G, int U, class Vol, class Lab>
__global__ void __launch_bounds__(kThreads)
fwd_ch_lanes(const float* __restrict__ rows, int64_t n, Vol v, Lab l, joseph::March m, int C,
             float* __restrict__ out) {
  extern __shared__ float sums[];
  joseph::fwd_ch_lanes<G, U>(rows, n, v, l, m, C, C, sums + threadIdx.x / G, kThreads / G, out,
                             thread_index());
}

// One ray's march with each sample's add made in sums[c * stride] itself,
// a read and a write at every sample (no register).
template <int U, class Vol, class Lab>
__device__ __forceinline__ void fwd_ch_rmw(const joseph::Ray& r, const Vol& v, const Lab& l,
                                           const joseph::March& m, int C, float* sums,
                                           int64_t stride) {
  for (int c = 0; c < C; ++c) sums[c * stride] = 0.f;
  int lo, hi;
  joseph::step_range(r, m, &lo, &hi);
  for (int p0 = lo; p0 < hi; p0 += U) {
    int c[U];
    float x[U];
    joseph::channel_samples<U>(r, v, l, m, C, p0, 1, hi, c, x);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c[u] >= 0) sums[c[u] * stride] += x[u];
  }
}

// kind 2 (in_shared false) and 3 (true: C * kThreads floats of shared memory).
template <bool in_shared, int U>
__global__ void __launch_bounds__(kThreads)
fwd_ch_rmw_kernel(const float* __restrict__ rows, int64_t n, brick::Volume<A> v, BrickLabels l,
                  joseph::March m, int C, float* __restrict__ out) {
  extern __shared__ float sums[];
  int64_t r = thread_index();
  if (r >= n) return;
  joseph::Ray ray = joseph::load_ray(rows, n, r);
  if (!in_shared) {
    fwd_ch_rmw<U>(ray, v, l, m, C, out + r, n);
    return;
  }
  float* mine = sums + threadIdx.x;
  fwd_ch_rmw<U>(ray, v, l, m, C, mine, kThreads);
  for (int c = 0; c < C; ++c) out[c * n + r] = mine[c * kThreads];
}

__global__ void __launch_bounds__(kThreads)
fwd_ch_parent(const float* __restrict__ rows, int64_t n, joseph::Volume v, joseph::Labels l,
              joseph::March m, int C, float* __restrict__ out) {
  int64_t r = thread_index();
  if (r >= n) return;
  joseph::trace_fwd_ch(joseph::load_ray(rows, n, r), v, l, m, C, out + r, n);
}

int fwd_ch_probe(int kind, int layout, int n_lanes, int unroll, const float* rows, int64_t n,
                 const joseph::Volume& sv, const brick::Volume<A>& bv, const joseph::Labels& sl,
                 const BrickLabels& bl, joseph::March m, int C, float* out, cudaStream_t st) {
  size_t smem = (size_t)C * kThreads / n_lanes * sizeof(float);
  if (smem > 48 * 1024) return -1;
#define LANES(G, U)                                                                     \
  fwd_ch_lanes<G, U><<<n_blocks(n * G), kThreads, (size_t)C * (kThreads / G) * 4, st>>>( \
      rows, n, VOL, LAB, m, C, out)
  if (kind == 0 && layout == 0) {
#define VOL sv
#define LAB sl
    PROBE_LANES(LANES)
#undef VOL
#undef LAB
  } else if (kind == 0 && layout == 1) {
#define VOL bv
#define LAB bl
    PROBE_LANES(LANES)
#undef VOL
#undef LAB
  } else if (kind == 1 && layout == 1) {
    NoLoad nv{bv, 0, bv.X, bv.Y, bv.Z};
    NoLoadLabels nl{bl, 0, bl.X, bl.Y, bl.Z};
#define VOL nv
#define LAB nl
    PROBE_LANES(LANES)
#undef VOL
#undef LAB
  } else if ((kind == 2 || kind == 3) && layout == 1 && n_lanes == 1) {
#define RMW(G, U)                                                                          \
  if (kind == 2)                                                                           \
    fwd_ch_rmw_kernel<false, U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, bv, bl, m, C, out); \
  else                                                                                     \
    fwd_ch_rmw_kernel<true, U><<<n_blocks(n), kThreads, smem, st>>>(rows, n, bv, bl, m, C, out)
    PROBE_UNROLL(RMW, 1)
#undef RMW
  } else if (kind == 4 && layout == 0 && n_lanes == 1 && unroll == 1) {
    fwd_ch_parent<<<n_blocks(n), kThreads, 0, st>>>(rows, n, sv, sl, m, C, out);
  } else {
    return -1;
  }
#undef LANES
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// siddon_fwd_max
// ---------------------------------------------------------------------------

template <int U, class Vol>
__global__ void __launch_bounds__(kThreads)
fwd_max_thread(const float* __restrict__ rows, int64_t n, Vol v, float* __restrict__ out,
               int* __restrict__ arg) {
  int64_t r = thread_index();
  if (r >= n) return;
  siddon::trace_fwd_max<U>(siddon::load_ray(rows, n, r), v, out + r, arg + r);
}

template <int G, int U, class Vol>
__global__ void __launch_bounds__(kThreads)
fwd_max_lanes(const float* __restrict__ rows, int64_t n, Vol v, float* __restrict__ out,
              int* __restrict__ arg) {
  siddon::fwd_max_lanes<G, U>(rows, n, v, out, arg, thread_index());
}

int fwd_max_probe(int kind, int layout, int n_lanes, int unroll, const float* rows, int64_t n,
                  const siddon::Volume& sv, const brick::Volume<A>& bv, float* out, int* arg,
                  cudaStream_t st) {
#define THREAD(G, U) fwd_max_thread<U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, VOL, out, arg)
#define LANES(G, U) \
  fwd_max_lanes<G, U><<<n_blocks(n * G), kThreads, 0, st>>>(rows, n, VOL, out, arg)
  if (kind == 0 && n_lanes == 1 && layout == 0) {
#define VOL sv
    PROBE_UNROLL(THREAD, 1)
#undef VOL
  } else if (kind == 0 && n_lanes == 1 && layout == 1) {
#define VOL bv
    PROBE_UNROLL(THREAD, 1)
#undef VOL
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
#undef THREAD
#undef LANES
  return (int)cudaGetLastError();
}

}  // namespace probe

// The bricked arguments are those of joseph_fwd_ch and siddon_fwd_max: the
// march axis, then the (s, y, z) axes' brick strides and extents, which the
// labelmap's bricked copy shares.
extern "C" int probe_fwd_ch(int kind, int layout, int n_lanes, int unroll, const float* rows,
                            int64_t n, const float* strided, int64_t ss, int64_t sy, int64_t sz,
                            const float* bricked, int axis, int bs_s, int bs_y, int bs_z, int X,
                            int Y, int Z, const int* labels, int64_t ls, int64_t ly, int64_t lz,
                            const float* blabels, float h, int n_steps, int blend, int C,
                            float* out, void* stream) {
  if (axis != probe::A) return -2;
  if (n <= 0) return 0;
  joseph::Volume sv{strided, ss, sy, sz, X, Y, Z};
  joseph::Labels sl{labels, ls, ly, lz, X, Y, Z};
  probe::BrickLabels bl{brick::make_volume<probe::A>(blabels, bs_s, bs_y, bs_z, X, Y, Z)};
  return probe::fwd_ch_probe(kind, layout, n_lanes, unroll, rows, n, sv,
                             brick::make_volume<probe::A>(bricked, bs_s, bs_y, bs_z, X, Y, Z), sl,
                             bl, probe::make_march(h, n_steps, blend), C, out,
                             (cudaStream_t)stream);
}

extern "C" int probe_fwd_max(int kind, int layout, int n_lanes, int unroll, const float* rows,
                             int64_t n, const float* strided, int64_t ss, int64_t sy, int64_t sz,
                             const float* bricked, int axis, int bs_s, int bs_y, int bs_z, int X,
                             int Y, int Z, float* out, int* arg, void* stream) {
  if (axis != probe::A) return -2;
  if (n <= 0) return 0;
  siddon::Volume sv{strided, ss, sy, sz, X, Y, Z};
  return probe::fwd_max_probe(kind, layout, n_lanes, unroll, rows, n, sv,
                              brick::make_volume<probe::A>(bricked, bs_s, bs_y, bs_z, X, Y, Z),
                              out, arg, (cudaStream_t)stream);
}
#else  // PROBE_BF16
using brick::bf16;
using BV = brick::Volume<A, bf16>;

// The bf16 copy as the parent's bf16 build read it: voxel() of the float32
// code, each read widened where it lands (joseph::voxel on a
// brick::Volume: brick::load). Over such a volume channel_samples is the float32
// copy's, as that build had it.
struct Widened {
  BV b;
  int X, Y, Z;
};

__host__ __device__ __forceinline__ float voxel(const Widened& v, int k, float fy, float fz) {
  return joseph::voxel(v.b, k, fy, fz);
}

// The density and the labelmap that variant V reads: the bf16 copy and the
// labelmap's copy (0), Widened and the labelmap's copy (1), or NoLoad and
// NoLoadLabels over their geometry (2: the offsets are the same in
// elements; nothing is read, every label 0), made on the host so that the
// zeros are kernel arguments.
template <int V>
using VolOf = std::conditional_t<V == 1, Widened, std::conditional_t<V == 2, NoLoad, BV>>;
template <int V>
using LabOf = std::conditional_t<V == 2, NoLoadLabels, BrickLabels>;

template <int V>
VolOf<V> volume_of(const BV& b) {
  if constexpr (V == 1) {
    return Widened{b, b.X, b.Y, b.Z};
  } else if constexpr (V == 2) {
    return NoLoad{brick::make_volume<A>(static_cast<const float*>(nullptr), b.bs_s, b.bs_y,
                                        b.bs_z, b.X, b.Y, b.Z),
                  0, b.X, b.Y, b.Z};
  } else {
    return b;
  }
}

template <int V>
LabOf<V> labels_of(const BrickLabels& l) {
  if constexpr (V == 2) {
    return NoLoadLabels{l, 0, l.X, l.Y, l.Z};
  } else {
    return l;
  }
}

template <int N>
using IC = std::integral_constant<int, N>;

// f(IC<V>(), IC<G>(), IC<U>()) for variant 0..2, G 4, 8 or 16 and U 1, 2
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
    default: return -1;
  }
}

// Registers, local-memory bytes and static shared-memory bytes of one
// kernel a thread or block, and its resident blocks an SM at kThreads
// threads and `dynamic` bytes of dynamic shared memory.
template <class K>
int attributes(K kernel, size_t dynamic, int* res) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[3], kernel, kThreads, dynamic);
  res[0] = a.numRegs;
  res[1] = (int)a.localSizeBytes;
  res[2] = (int)a.sharedSizeBytes;
  return (int)err;
}

// One kernel a variant V (the numbering at the top), so each has SASS of its
// own: C * (kThreads / G) floats of dynamic shared memory, as the package's.
template <int V, int G, int U>
__global__ void __launch_bounds__(kThreads)
fwd_ch_bf16(const float* __restrict__ rows, int64_t n, VolOf<V> v, LabOf<V> l, joseph::March m,
            int C, float* __restrict__ out) {
  extern __shared__ float sums[];
  joseph::fwd_ch_lanes<G, U>(rows, n, v, l, m, C, C, sums + threadIdx.x / G, kThreads / G, out,
                             thread_index());
}

}  // namespace probe

// The bf16 copy's and the labelmap copy's arguments are those of
// joseph_fwd_ch_bf16: the march axis, then the (s, y, z) axes' brick
// strides and extents. All C channels in one march: -1 where their sums
// pass 48 KB a block.
extern "C" int probe_fwd_ch_bf16(int variant, int n_lanes, int unroll, const float* rows,
                                 int64_t n, const brick::bf16* bricked, int axis, int bs_s,
                                 int bs_y, int bs_z, int X, int Y, int Z, const float* blabels,
                                 float h, int n_steps, int blend, int C, float* out,
                                 void* stream) {
  if (axis != probe::A) return -2;
  if (n <= 0) return 0;
  probe::BV v = brick::make_volume<probe::A>(bricked, bs_s, bs_y, bs_z, X, Y, Z);
  probe::BrickLabels l{brick::make_volume<probe::A>(blabels, bs_s, bs_y, bs_z, X, Y, Z)};
  joseph::March m = probe::make_march(h, n_steps, blend);
  int rc = probe::with_bf16_variant(variant, n_lanes, unroll, [&](auto var, auto g, auto u) {
    constexpr int V = decltype(var)::value, G = decltype(g)::value;
    size_t smem = (size_t)C * (probe::kThreads / G) * sizeof(float);
    if (smem > 48 * 1024) return -1;
    probe::fwd_ch_bf16<V, G, decltype(u)::value>
        <<<probe::n_blocks(n * G), probe::kThreads, smem, (cudaStream_t)stream>>>(
            rows, n, probe::volume_of<V>(v), probe::labels_of<V>(l), m, C, out);
    return 0;
  });
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// res[0..3]: registers a thread, local-memory bytes a thread, static
// shared-memory bytes a block, resident blocks an SM at C channels' sums,
// of the variant at G and U.
extern "C" int probe_fwd_ch_bf16_attributes(int variant, int n_lanes, int unroll, int C,
                                            int* res) {
  return probe::with_bf16_variant(variant, n_lanes, unroll, [&](auto var, auto g, auto u) {
    constexpr int V = decltype(var)::value, G = decltype(g)::value, U = decltype(u)::value;
    return probe::attributes(probe::fwd_ch_bf16<V, G, U>,
                             (size_t)C * (probe::kThreads / G) * sizeof(float), res);
  });
}
#endif  // PROBE_BF16
