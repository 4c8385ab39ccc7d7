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
//
// Built with -DPROBE_BF16, the file holds the bf16 probes instead
// (probe_bwd_rays_ch_bf16 and probe_bwd_rays_ch_bf16_attributes, below), on the density's
// bf16 bricked copy and the labelmap's copy (its int32 bits), at G = 4, 8
// or 16 lanes a ray and U = 1, 2 or 4 steps in flight a lane:
//   variant 0 the package's bwd_rays_ch_lanes (channel_terms's bf16
//             overload: the U steps' windows loaded raw with their labels,
//             widened only once every load has issued);
//           1 the parent's (channel_terms of the float32 copy over a
//             volume whose voxel() is brick::load: each read widened, and
//             in blend mode lerped, where it lands, as the first bf16 build
//             had it);
//           2 the march without loads (the float32 probe's kind 1 at the
//             same G and U: every offset computed, nothing read, every
//             label 0).
// probe_bwd_rays_ch_bf16_attributes gives a variant's registers, local memory
// and static shared memory a thread or block, and its resident blocks an
// SM (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor).
#include <cuda_runtime.h>

#include <type_traits>

#include "joseph.cuh"

#ifndef PROBE_AXIS
#define PROBE_AXIS 2
#endif

namespace probe {

constexpr int kThreads = 128;
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

joseph::March make_march(float h, int n_steps, int blend) {
  joseph::March m;
  m.h = h;
  m.n_steps = n_steps;
  m.blend = blend != 0;
  return m;
}

#if !defined(PROBE_BF16)
constexpr int kWarp = 32;

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
#else  // PROBE_BF16
using brick::bf16;
using BV = brick::Volume<A, bf16>;

// The bf16 copy as the parent's bf16 build read it: voxel() of the float32
// code, each read widened where it lands (joseph::voxel on a
// brick::Volume: brick::load). Over such a volume channel_terms is the float32
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
// own.
template <int V, int G, int U>
__global__ void __launch_bounds__(kThreads)
rays_ch_bf16(const float* __restrict__ rows, int64_t n, VolOf<V> v, LabOf<V> l, joseph::March m,
             int C, const float* __restrict__ g, float* __restrict__ out) {
  joseph::bwd_rays_ch_lanes<G, U>(rows, n, v, l, m, C, g, out, thread_index());
}

}  // namespace probe

// The bf16 copy's and the labelmap copy's arguments are those of
// joseph_bwd_rays_ch_bf16: the march axis, then the (s, y, z) axes' brick
// strides and extents; g the (C, n) cotangent, out (7, n).
extern "C" int probe_bwd_rays_ch_bf16(int variant, int n_lanes, int unroll, const float* rows,
                                      int64_t n, const brick::bf16* bricked, int axis, int bs_s,
                                      int bs_y, int bs_z, int X, int Y, int Z,
                                      const float* blabels, float h, int n_steps, int blend, int C,
                                      const float* g, float* out, void* stream) {
  if (axis != probe::A) return -2;
  if (n <= 0) return 0;
  probe::BV v = brick::make_volume<probe::A>(bricked, bs_s, bs_y, bs_z, X, Y, Z);
  probe::BrickLabels l{brick::make_volume<probe::A>(blabels, bs_s, bs_y, bs_z, X, Y, Z)};
  joseph::March m = probe::make_march(h, n_steps, blend);
  int rc = probe::with_bf16_variant(variant, n_lanes, unroll, [&](auto var, auto gl, auto u) {
    constexpr int V = decltype(var)::value, G = decltype(gl)::value;
    probe::rays_ch_bf16<V, G, decltype(u)::value>
        <<<probe::n_blocks(n * G), probe::kThreads, 0, (cudaStream_t)stream>>>(
            rows, n, probe::volume_of<V>(v), probe::labels_of<V>(l), m, C, g, out);
    return 0;
  });
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// res[0..3]: registers a thread, local-memory bytes a thread, static
// shared-memory bytes a block, resident blocks an SM, of the variant at G
// and U.
extern "C" int probe_bwd_rays_ch_bf16_attributes(int variant, int n_lanes, int unroll,
                                                 int* res) {
  return probe::with_bf16_variant(variant, n_lanes, unroll, [&](auto var, auto gl, auto u) {
    constexpr int V = decltype(var)::value, G = decltype(gl)::value, U = decltype(u)::value;
    return probe::attributes(probe::rays_ch_bf16<V, G, U>, 0, res);
  });
}
#endif  // PROBE_BF16
