// Probe kernels of diffdrr_tpu_torch/experiments/fwd_timing.py (sm_90a):
// variants of siddon_fwd and joseph_fwd built from the same headers, to see
// what bounds the two forward gathers. fwd_timing.py compiles this file
// with the package's nvcc flags and -I diffdrr_tpu_torch/csrc, once for
// each brick shape it probes (brick.cuh's BRICK_L0..L2 set with -D); the
// package never loads it.
//
// Each entry point takes the density twice, strided (its own layout, as
// the kernels before the bricked copy read it) and bricked (brick.cuh),
// and three choices:
//   layout  0 strided, 1 bricked;
//   kind    0 the forward (trace_fwd with `unroll` slabs or steps in flight:
//             layout 0 with unroll 1 is the strided kernel the bricked one
//             replaced); 1 the march without loads (bricked: every offset
//             computed, nothing read); 2 the loads only (per slab or step
//             of the ray's range, the voxels at the ray's position there,
//             none of the segment or tent arithmetic: two voxels a Siddon
//             slab, the four in-plane neighbours a Joseph step at integer h);
//             3 (Joseph, bricked) the forward with its windows loaded raw
//             before any is lerped (trace_fwd_raw: the float32 kernel's
//             order in blend mode; kind 0 bricked is window()'s, which
//             lerps each plane pair as its loads land, the kernel's order
//             at an integer h);
//   unroll  1, 2 or 4.
// One thread per ray, 128 threads a block, as in the kernels. Each returns
// cudaGetLastError(), or -1 for a combination it does not build.
//
// The build with the kernels' own brick shape (4x4x4) also has the bf16
// probes, probe_siddon_fwd_bf16 and probe_joseph_fwd_bf16, on a bf16
// bricked copy alone, with
//   variant 0 the package's trace_fwd (the kernels' bf16 forward: reads kept
//             raw until the sums); 1 the first bf16 build's (each read
//             widened where it lands, then the float32 code: a copy of
//             its trace_fwd);
//             2 reads kept raw by a branch around each load (read_raw's
//             C++); 3 reads kept raw by a predicated ld.global.nc.u16 in
//             inline PTX into a register zeroed beforehand;
//   kind    0 the forward; 2 the loads only, raw, widened in the sums;
//   unroll  1, 2, 4 or 8.
#include <cuda_runtime.h>

#include <type_traits>

#include "joseph.cuh"
#include "siddon.cuh"

namespace probe {

constexpr int kThreads = 128;

// The bricked copy with each read replaced by its offset ANDed with a zero
// known only at run time: the address arithmetic stays, the load goes.
template <int A>
struct NoLoad {
  brick::Volume<A> b;
  int zero;
  int X, Y, Z;
};

template <int A>
__host__ __device__ __forceinline__ float voxel(const NoLoad<A>& v, int k, float fy, float fz) {
  if (!(k >= 0 && k < v.X && fy >= 0.f && fy < (float)v.Y && fz >= 0.f && fz < (float)v.Z))
    return 0.f;
  return (float)((int)brick::offset(v.b, k, (int)fy, (int)fz) & v.zero);
}

// A float32 bricked copy (trace_fwd_raw reads only those here).
template <class Vol>
struct IsBricked : std::false_type {};
template <int A>
struct IsBricked<brick::Volume<A>> : std::true_type {};

unsigned int n_blocks(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

template <int U, class Vol>
__global__ void __launch_bounds__(kThreads)
siddon_fwd(const float* __restrict__ rows, int64_t n, Vol v, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  out[r] = siddon::trace_fwd<U>(siddon::load_ray(rows, n, r), v);
}

template <int U, class Vol>
__global__ void __launch_bounds__(kThreads)
siddon_loads(const float* __restrict__ rows, int64_t n, Vol v, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  using siddon::voxel;  // and probe::voxel for NoLoad, by argument lookup
  siddon::Ray ray = siddon::load_ray(rows, n, r);
  int lo, hi;
  siddon::slab_range(ray, v.X, &lo, &hi);
  float acc = 0.f;
  for (int s0 = lo; s0 < hi; s0 += U) {
    float V[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int s = s0 + u;
      float alpha = (float)s * ray.a + ray.b;
      float fy = floorf(ray.gy + alpha * ray.dy);
      float fz = floorf(ray.gz + alpha * ray.dz);
      bool ok = s < hi;
      V[u][0] = ok ? voxel(v, s, fy, fz) : 0.f;
      V[u][1] = ok ? voxel(v, s, fy + 1.f, fz + 1.f) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += V[u][0] + V[u][1];
  }
  out[r] = acc;
}

// siddon_loads on a bf16 copy: the same reads kept raw, widened in the sums.
template <int U, int A>
__global__ void __launch_bounds__(kThreads)
siddon_loads_bf16(const float* __restrict__ rows, int64_t n,
                  brick::Volume<A, brick::bf16> v, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  siddon::Ray ray = siddon::load_ray(rows, n, r);
  int lo, hi;
  siddon::slab_range(ray, v.X, &lo, &hi);
  float acc = 0.f;
  for (int s0 = lo; s0 < hi; s0 += U) {
    brick::bf16 V[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int s = s0 + u;
      float alpha = (float)s * ray.a + ray.b;
      float fy = floorf(ray.gy + alpha * ray.dy);
      float fz = floorf(ray.gz + alpha * ray.dz);
      bool ok = s < hi;
      V[u][0] = ok ? siddon::voxel_raw(v, s, fy, fz) : (brick::bf16)0;
      V[u][1] = ok ? siddon::voxel_raw(v, s, fy + 1.f, fz + 1.f) : (brick::bf16)0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += brick::widen(V[u][0]) + brick::widen(V[u][1]);
  }
  out[r] = acc;
}

template <int U, class Vol>
__global__ void __launch_bounds__(kThreads)
joseph_fwd(const float* __restrict__ rows, int64_t n, Vol v, joseph::March m,
           float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  out[r] = joseph::trace_fwd<U>(joseph::load_ray(rows, n, r), v, m);
}

template <int U, int A>
__global__ void __launch_bounds__(kThreads)
joseph_fwd_raw(const float* __restrict__ rows, int64_t n, brick::Volume<A> v, joseph::March m,
               float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  out[r] = joseph::trace_fwd_raw<U>(joseph::load_ray(rows, n, r), v, m);
}

template <int U, class Vol>
__global__ void __launch_bounds__(kThreads)
joseph_loads(const float* __restrict__ rows, int64_t n, Vol v, joseph::March m,
             float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  using joseph::voxel;  // and probe::voxel for NoLoad, by argument lookup
  joseph::Ray ray = joseph::load_ray(rows, n, r);
  int lo, hi;
  joseph::step_range(ray, m, &lo, &hi);
  int step = (int)rintf(m.h);
  float acc = 0.f;
  for (int p0 = lo; p0 < hi; p0 += U) {
    float V[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int p = p0 + u;
      float alpha = (float)p * m.h * ray.a + ray.b;
      float fy = floorf(ray.gy + alpha * ray.dy);
      float fz = floorf(ray.gz + alpha * ray.dz);
      int k = p < hi ? p * step : -1;  // plane -1 reads nothing
      V[u][0] = voxel(v, k, fy, fz);
      V[u][1] = voxel(v, k, fy, fz + 1.f);
      V[u][2] = voxel(v, k, fy + 1.f, fz);
      V[u][3] = voxel(v, k, fy + 1.f, fz + 1.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += (V[u][0] + V[u][1]) + (V[u][2] + V[u][3]);
  }
  out[r] = acc;
}

// joseph_loads on a bf16 copy: the same reads kept raw (plane k only: the
// window of an integer h), widened in the sums.
template <int U, int A>
__global__ void __launch_bounds__(kThreads)
joseph_loads_bf16(const float* __restrict__ rows, int64_t n,
                  brick::Volume<A, brick::bf16> v, joseph::March m, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  joseph::Ray ray = joseph::load_ray(rows, n, r);
  int lo, hi;
  joseph::step_range(ray, m, &lo, &hi);
  int step = (int)rintf(m.h);
  float acc = 0.f;
  for (int p0 = lo; p0 < hi; p0 += U) {
    brick::bf16 V[U][2][2][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int p = p0 + u;
      joseph::Step st;
      st.k0 = p * step;
      float alpha = (float)p * m.h * ray.a + ray.b;
      st.fy = floorf(ray.gy + alpha * ray.dy);
      st.fz = floorf(ray.gz + alpha * ray.dz);
      joseph::window_raw(v, st, false, p < hi, V[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      acc += (brick::widen(V[u][0][0][0]) + brick::widen(V[u][0][0][1])) +
             (brick::widen(V[u][0][1][0]) + brick::widen(V[u][0][1][1]));
  }
  out[r] = acc;
}

#define PROBE_UNROLL(CALL)        \
  switch (unroll) {               \
    case 1: CALL(1); break;       \
    case 2: CALL(2); break;       \
    case 4: CALL(4); break;       \
    default: return -1;           \
  }

template <class Vol>
int siddon_launch(int kind, int unroll, const float* rows, int64_t n, Vol v, float* out,
                  cudaStream_t st) {
#define S_FWD(U) siddon_fwd<U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, v, out)
#define S_LOADS(U) siddon_loads<U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, v, out)
  if (kind == 0) {
    PROBE_UNROLL(S_FWD)
  } else if (kind == 2) {
    PROBE_UNROLL(S_LOADS)
  } else {
    return -1;
  }
#undef S_FWD
#undef S_LOADS
  return (int)cudaGetLastError();
}

template <class Vol>
int joseph_launch(int kind, int unroll, const float* rows, int64_t n, Vol v, joseph::March m,
                  float* out, cudaStream_t st) {
#define J_FWD(U) joseph_fwd<U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, v, m, out)
#define J_RAW(U) joseph_fwd_raw<U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, v, m, out)
#define J_LOADS(U) joseph_loads<U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, v, m, out)
  if (kind == 0) {
    PROBE_UNROLL(J_FWD)
  } else if (kind == 3) {
    if constexpr (IsBricked<Vol>::value) {
      PROBE_UNROLL(J_RAW)
    } else {
      return -1;
    }
  } else if (kind == 2) {
    if (m.blend) return -1;
    PROBE_UNROLL(J_LOADS)
  } else {
    return -1;
  }
#undef J_FWD
#undef J_RAW
#undef J_LOADS
  return (int)cudaGetLastError();
}

template <int A>
NoLoad<A> no_load(const brick::Volume<A>& b) {
  NoLoad<A> v;
  v.b = b;
  v.zero = 0;
  v.X = b.X;
  v.Y = b.Y;
  v.Z = b.Z;
  return v;
}

}  // namespace probe

namespace probe {

template <int A>
int siddon_probe(int layout, int kind, int unroll, const float* rows, int64_t n,
                 const siddon::Volume& sv, brick::Volume<A> bv, float* out, cudaStream_t st) {
  if (kind == 1) return layout == 1 ? siddon_launch(0, unroll, rows, n, no_load(bv), out, st) : -1;
  return layout == 0 ? siddon_launch(kind, unroll, rows, n, sv, out, st)
                     : siddon_launch(kind, unroll, rows, n, bv, out, st);
}

template <int A>
int joseph_probe(int layout, int kind, int unroll, const float* rows, int64_t n,
                 const joseph::Volume& jv, brick::Volume<A> bv, joseph::March m, float* out,
                 cudaStream_t st) {
  if (kind == 1)
    return layout == 1 ? joseph_launch(0, unroll, rows, n, no_load(bv), m, out, st) : -1;
  if (kind == 3) return layout == 1 ? joseph_launch(3, unroll, rows, n, bv, m, out, st) : -1;
  return layout == 0 ? joseph_launch(kind, unroll, rows, n, jv, m, out, st)
                     : joseph_launch(kind, unroll, rows, n, bv, m, out, st);
}

}  // namespace probe

#if BRICK_L0 == 2 && BRICK_L1 == 2 && BRICK_L2 == 2
namespace probe {

using brick::bf16;

// The first bf16 build's siddon trace_fwd: each read widened where it lands
// (siddon::voxel, brick::load), then the float32 code.
template <int U, int A>
__device__ __forceinline__ float siddon_widened(const siddon::Ray& r,
                                                const brick::Volume<A, bf16>& v) {
  int lo, hi;
  siddon::slab_range(r, v.X, &lo, &hi);
  float acc = 0.f;
  for (int s0 = lo; s0 < hi; s0 += U) {
    float len[U][3], V[U][3];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int s = s0 + u;
      siddon::Slab sl = siddon::slab_segments(r, s);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        len[u][j] = sl.len[j];
        V[u][j] = (s < hi && sl.len[j] > 0.f)
                      ? siddon::voxel(v, s, sl.y0 + sl.iy[j], sl.z0 + sl.iz[j])
                      : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u >= hi) break;
      float seg = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) seg += V[u][j] * len[u][j];
      acc += r.w * seg;
    }
  }
  return acc;
}

// The 16 bits at p where ok, else zero bits: a branch around the load
// (kBranch, read_raw's C++), or a predicated load in inline PTX into a
// register zeroed beforehand (kPredicated), whose result the compiler
// cannot fold a widening into.
enum RawRead { kBranch, kPredicated };

template <RawRead How>
__device__ __forceinline__ bf16 load_if(bool ok, const bf16* p) {
  if constexpr (How == kBranch) {
    return ok ? brick::load_raw(p) : (bf16)0;
  } else {
    unsigned short x;
    asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\tmov.u16 %0, 0;\n\t"
        "@q ld.global.nc.u16 %0, [%1];\n\t}"
        : "=h"(x)
        : "l"(p), "r"((unsigned)ok));
    return x;
  }
}

// The voxel at (k, fy, fz) of a bf16 copy where `read` and inside, else
// zero bits; the offset only taken where it is read.
template <RawRead How, int A>
__device__ __forceinline__ bf16 raw_at(const brick::Volume<A, bf16>& v, bool read, int k,
                                       float fy, float fz) {
  bool ok = read && k >= 0 && k < v.X && fy >= 0.f && fy < (float)v.Y && fz >= 0.f &&
            fz < (float)v.Z;
  return load_if<How>(ok, v.data + (ok ? brick::offset(v, k, (int)fy, (int)fz) : 0));
}

// The package's siddon trace_fwd on a bf16 copy with its reads made by
// raw_at<How>.
template <int U, RawRead How, int A>
__device__ __forceinline__ float siddon_raw(const siddon::Ray& r,
                                            const brick::Volume<A, bf16>& v) {
  int lo, hi;
  siddon::slab_range(r, v.X, &lo, &hi);
  float acc = 0.f;
  for (int s0 = lo; s0 < hi; s0 += U) {
    float len[U][3];
    bf16 V[U][3];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int s = s0 + u;
      siddon::Slab sl = siddon::slab_segments(r, s);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        len[u][j] = sl.len[j];
        V[u][j] = raw_at<How>(v, s < hi && sl.len[j] > 0.f, s, sl.y0 + sl.iy[j],
                              sl.z0 + sl.iz[j]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u >= hi) break;
      float seg = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) seg += brick::widen(V[u][j]) * len[u][j];
      acc += r.w * seg;
    }
  }
  return acc;
}

// The first bf16 build's joseph trace_fwd: the float32 code, each read
// widened where it lands (joseph::window, brick::load).
template <int U, int A>
__device__ __forceinline__ float joseph_widened(const joseph::Ray& r,
                                                const brick::Volume<A, bf16>& v,
                                                const joseph::March& m) {
  int lo, hi;
  joseph::step_range(r, m, &lo, &hi);
  float acc = 0.f;
  for (int p0 = lo; p0 < hi; p0 += U) {
    joseph::Step st[U];
    bool in[U];
    float win[U][2][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      st[u] = joseph::step_at(r, m, v.X, p0 + u);
      in[u] = p0 + u < hi && st[u].inslab;
      if (in[u]) {
        joseph::window(v, st[u], m.blend, win[u]);
      } else {
        win[u][0][0] = win[u][0][1] = win[u][1][0] = win[u][1][1] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (in[u]) acc += joseph::sample(st[u], win[u]);
  }
  return acc;
}

// The package's joseph trace_fwd on a bf16 copy with its window's reads
// made by raw_at<How>.
template <int U, RawRead How, int A>
__device__ __forceinline__ float joseph_raw(const joseph::Ray& r,
                                            const brick::Volume<A, bf16>& v,
                                            const joseph::March& m) {
  int lo, hi;
  joseph::step_range(r, m, &lo, &hi);
  float acc = 0.f;
  for (int p0 = lo; p0 < hi; p0 += U) {
    joseph::Step st[U];
    bool in[U];
    bf16 raw[U][2][2][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      st[u] = joseph::step_at(r, m, v.X, p0 + u);
      in[u] = p0 + u < hi && st[u].inslab;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            raw[u][q][a][b] = raw_at<How>(v, in[u] && (q == 0 || m.blend), st[u].k0 + q,
                                          st[u].fy + (float)a, st[u].fz + (float)b);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (in[u]) {
        float win[2][2];
        joseph::widen_window(raw[u], st[u], m.blend, win);
        acc += joseph::sample(st[u], win);
      }
    }
  }
  return acc;
}

// One kernel a variant V (the numbering above), so each has SASS of its own.
template <int V, int U, int A>
__global__ void __launch_bounds__(kThreads)
siddon_fwd_bf16(const float* __restrict__ rows, int64_t n, brick::Volume<A, bf16> v,
                float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  siddon::Ray ray = siddon::load_ray(rows, n, r);
  if constexpr (V == 0) {
    out[r] = siddon::trace_fwd<U>(ray, v);
  } else if constexpr (V == 1) {
    out[r] = siddon_widened<U>(ray, v);
  } else {
    out[r] = siddon_raw<U, V == 2 ? kBranch : kPredicated>(ray, v);
  }
}

template <int V, int U, int A>
__global__ void __launch_bounds__(kThreads)
joseph_fwd_bf16(const float* __restrict__ rows, int64_t n, brick::Volume<A, bf16> v,
                joseph::March m, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  joseph::Ray ray = joseph::load_ray(rows, n, r);
  if constexpr (V == 0) {
    out[r] = joseph::trace_fwd<U>(ray, v, m);
  } else if constexpr (V == 1) {
    out[r] = joseph_widened<U>(ray, v, m);
  } else {
    out[r] = joseph_raw<U, V == 2 ? kBranch : kPredicated>(ray, v, m);
  }
}

// f(IC<U>()) for unroll 1, 2, 4 or 8; -1 for another.
template <int N>
using IC = std::integral_constant<int, N>;
template <class F>
int with_unroll8(int unroll, F f) {
  switch (unroll) {
    case 1: return f(IC<1>());
    case 2: return f(IC<2>());
    case 4: return f(IC<4>());
    case 8: return f(IC<8>());
    default: return -1;
  }
}

// f(IC<V>()) for variant 0..3; -1 for another.
template <class F>
int with_variant(int variant, F f) {
  switch (variant) {
    case 0: return f(IC<0>());
    case 1: return f(IC<1>());
    case 2: return f(IC<2>());
    case 3: return f(IC<3>());
    default: return -1;
  }
}

template <int A>
int siddon_bf16(int variant, int kind, int unroll, const float* rows, int64_t n,
                brick::Volume<A, bf16> v, float* out, cudaStream_t st) {
  if (kind != 0 && kind != 2) return -1;
  int rc = with_unroll8(unroll, [&](auto u) {
    constexpr int U = decltype(u)::value;
    if (kind == 2) {
      siddon_loads_bf16<U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, v, out);
      return 0;
    }
    return with_variant(variant, [&](auto var) {
      siddon_fwd_bf16<decltype(var)::value, U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, v,
                                                                                 out);
      return 0;
    });
  });
  return rc != 0 ? rc : (int)cudaGetLastError();
}

template <int A>
int joseph_bf16(int variant, int kind, int unroll, const float* rows, int64_t n,
                brick::Volume<A, bf16> v, joseph::March m, float* out, cudaStream_t st) {
  if ((kind != 0 && kind != 2) || (kind == 2 && m.blend)) return -1;
  int rc = with_unroll8(unroll, [&](auto u) {
    constexpr int U = decltype(u)::value;
    if (kind == 2) {
      joseph_loads_bf16<U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, v, m, out);
      return 0;
    }
    return with_variant(variant, [&](auto var) {
      joseph_fwd_bf16<decltype(var)::value, U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, v,
                                                                                 m, out);
      return 0;
    });
  });
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace probe

// The bf16 probes' arguments: siddon_fwd_bf16's and joseph_fwd_bf16's
// (the bf16 bricked copy, the march axis, the (s, y, z) axes' brick strides
// and extents), after the variant, the kind and the unroll.
extern "C" int probe_siddon_fwd_bf16(int variant, int kind, int unroll, const float* rows,
                                     int64_t n, const brick::bf16* bricked, int axis, int bs_s,
                                     int bs_y, int bs_z, int X, int Y, int Z, float* out,
                                     void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return brick::with_axis(axis, [&](auto a) {
    constexpr int A = decltype(a)::value;
    return probe::siddon_bf16(variant, kind, unroll, rows, n,
                              brick::make_volume<A>(bricked, bs_s, bs_y, bs_z, X, Y, Z), out, st);
  });
}

extern "C" int probe_joseph_fwd_bf16(int variant, int kind, int unroll, const float* rows,
                                     int64_t n, const brick::bf16* bricked, int axis, int bs_s,
                                     int bs_y, int bs_z, int X, int Y, int Z, float h,
                                     int n_steps, int blend, float* out, void* stream) {
  if (n <= 0) return 0;
  joseph::March m;
  m.h = h;
  m.n_steps = n_steps;
  m.blend = blend != 0;
  cudaStream_t st = (cudaStream_t)stream;
  return brick::with_axis(axis, [&](auto a) {
    constexpr int A = decltype(a)::value;
    return probe::joseph_bf16(variant, kind, unroll, rows, n,
                              brick::make_volume<A>(bricked, bs_s, bs_y, bs_z, X, Y, Z), m, out,
                              st);
  });
}
#endif  // the kernels' own brick shape

// The bricked copy's volume for march axis A, from the C arguments.
#define PROBE_BV(A) brick::make_volume<A>(bricked, bs_s, bs_y, bs_z, X, Y, Z)

// The bricked arguments are those of siddon_fwd and joseph_fwd: the march
// axis, then the (s, y, z) axes' brick strides and extents.
extern "C" int probe_siddon_fwd(int layout, int kind, int unroll, const float* rows,
                                int64_t n, const float* strided, int64_t ss, int64_t sy,
                                int64_t sz, const float* bricked, int axis, int bs_s,
                                int bs_y, int bs_z, int X, int Y, int Z, float* out,
                                void* stream) {
  if (n <= 0) return 0;
  siddon::Volume sv{strided, ss, sy, sz, X, Y, Z};
  cudaStream_t st = (cudaStream_t)stream;
#define S_PROBE(A) probe::siddon_probe(layout, kind, unroll, rows, n, sv, PROBE_BV(A), out, st)
  switch (axis) {
    case 0: return S_PROBE(0);
    case 1: return S_PROBE(1);
    case 2: return S_PROBE(2);
    default: return -1;
  }
#undef S_PROBE
}

extern "C" int probe_joseph_fwd(int layout, int kind, int unroll, const float* rows,
                                int64_t n, const float* strided, int64_t ss, int64_t sy,
                                int64_t sz, const float* bricked, int axis, int bs_s,
                                int bs_y, int bs_z, int X, int Y, int Z, float h,
                                int n_steps, int blend, float* out, void* stream) {
  if (n <= 0) return 0;
  joseph::March m;
  m.h = h;
  m.n_steps = n_steps;
  m.blend = blend != 0;
  joseph::Volume jv{strided, ss, sy, sz, X, Y, Z};
  cudaStream_t st = (cudaStream_t)stream;
#define J_PROBE(A) probe::joseph_probe(layout, kind, unroll, rows, n, jv, PROBE_BV(A), m, out, st)
  switch (axis) {
    case 0: return J_PROBE(0);
    case 1: return J_PROBE(1);
    case 2: return J_PROBE(2);
    default: return -1;
  }
#undef J_PROBE
}
