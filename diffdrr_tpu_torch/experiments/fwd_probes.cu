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
//   unroll  1, 2 or 4.
// One thread per ray, 128 threads a block, as in the kernels. Each returns
// cudaGetLastError(), or -1 for a combination it does not build.
#include <cuda_runtime.h>

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

template <int U, class Vol>
__global__ void __launch_bounds__(kThreads)
joseph_fwd(const float* __restrict__ rows, int64_t n, Vol v, joseph::March m,
           float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  out[r] = joseph::trace_fwd<U>(joseph::load_ray(rows, n, r), v, m);
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
#define J_LOADS(U) joseph_loads<U><<<n_blocks(n), kThreads, 0, st>>>(rows, n, v, m, out)
  if (kind == 0) {
    PROBE_UNROLL(J_FWD)
  } else if (kind == 2) {
    if (m.blend) return -1;
    PROBE_UNROLL(J_LOADS)
  } else {
    return -1;
  }
#undef J_FWD
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
  return layout == 0 ? joseph_launch(kind, unroll, rows, n, jv, m, out, st)
                     : joseph_launch(kind, unroll, rows, n, bv, m, out, st);
}

}  // namespace probe

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
