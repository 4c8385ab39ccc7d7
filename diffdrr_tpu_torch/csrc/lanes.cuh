// G lanes a ray: how the fused pose kernels share a ray's march.
//
// siddon_fwdgrad and joseph_fwdgrad give each ray G neighbouring lanes of
// a warp (G a power of two dividing 32, a compile-time constant). The ray's
// march goes in passes of G * U slabs (steps): in the pass from slab base,
// lane j computes the summands of slabs base + j, base + j + G, ...,
// base + j + (U - 1) G, so neighbouring lanes read neighbouring slabs of the
// ray, and each lane keeps U slabs' loads in flight.
//
// Sums: the ray's accumulators take each pass's summands in slab order,
// acc_k = ((acc_k + t_k(base)) + t_k(base + 1)) + ..., the serial march's
// own sequence of roundings, so the rows are the serial march's bit for
// bit whatever G and U (and the kernels' rows equal their plain versions
// and the two-pass backward's to the last bit, as the one-thread-per-ray
// kernels' did). Row k is kept by the ray's lane k % G, in its slot k / G:
// the lanes hand a pass's summands over through shared memory, laid out
// by row and by slab, and each lane then adds up its rows' summands in slab
// order (take_in_order), so the G lanes add in parallel, one row each,
// instead of all lanes adding every row.
//
// First maximum (MIP): each lane keeps the first maximum of its own slabs
// by the serial strict >, and the ray's G lanes then combine in a fixed
// tree (stage o = 1, 2, 4, ..., G / 2: every lane takes in the maximum of
// lane j ^ o as it stood before the stage). The larger value wins, of two
// equal ones the smaller slab: the serial first maximum, exactly, and
// after the last stage every lane holds it. The device runs the stages
// with __shfl_xor_sync (combine_max_warp), a host build over an array of
// the G lanes' maxima (combine_max_lanes).
//
// Shared by siddon.cuh and joseph.cuh, and so by the host twin in the
// tests, which runs the same take_in_order and tree over arrays.
#pragma once

#include <string.h>

#if defined(__CUDACC__)
#define LANES_HD __host__ __device__ __forceinline__
#else
#define LANES_HD inline
#endif

namespace lanes {

// The rows a lane keeps of N, with G lanes a ray.
template <int G, int N>
constexpr int kSlots = (N + G - 1) / G;

// Lane `lane`'s share of a pass's sums: for each of its rows k = lane +
// slot * G < N, acc[slot] takes terms[k * stride + c] for the pass's slabs
// c = 0, 1, ..., kSlabs - 1 in that order.
template <int G, int N, int kSlabs>
LANES_HD void take_in_order(const float* terms, int stride, int lane, float acc[]) {
#pragma unroll
  for (int slot = 0; slot < kSlots<G, N>; ++slot) {
    int k = lane + slot * G;
    if (k < N) {
#pragma unroll
      for (int c = 0; c < kSlabs; ++c) acc[slot] += terms[k * stride + c];
    }
  }
}

// The first maximum: does (v, arg) beat (v_mine, arg_mine)? A larger value
// wins, and of two equal values the smaller arg, so the result is the
// serial march's first maximum (a lane with no maximum has value 0 and arg
// -1; a maximum it records is above 0).
LANES_HD bool first_max_beats(float v, int arg, float v_mine, int arg_mine) {
  return v > v_mine || (v == v_mine && arg < arg_mine);
}

// One stage of the first maximum: mine takes other's rows (value row kVal
// among them) and arg when other beats it.
template <int N, int kVal>
LANES_HD void max_pair(float mine[N], int* arg_mine, const float other[N], int arg_other) {
  if (first_max_beats(other[kVal], arg_other, mine[kVal], *arg_mine)) {
#pragma unroll
    for (int k = 0; k < N; ++k) mine[k] = other[k];
    *arg_mine = arg_other;
  }
}

// The host's run of the tree over all G lanes: part[j] holds lane j's N
// rows and arg[j] its argmax.
template <int G, int N, int kVal>
inline void combine_max_lanes(float (*part)[N], int* arg) {
  for (int o = 1; o < G; o <<= 1) {
    float before[G][N];
    int before_arg[G];
    memcpy(before, part, sizeof(before));
    memcpy(before_arg, arg, sizeof(before_arg));
    for (int j = 0; j < G; ++j)
      max_pair<N, kVal>(part[j], &arg[j], before[j ^ o], before_arg[j ^ o]);
  }
}

#if defined(__CUDACC__)
constexpr unsigned kFullMask = 0xffffffffu;

// The device's run of the tree: every lane of the warp calls it (lanes of
// rays past the end too), since each shuffle takes all 32.
template <int G, int N, int kVal>
__device__ __forceinline__ void combine_max_warp(float acc[N], int* arg) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    float other[N];
#pragma unroll
    for (int k = 0; k < N; ++k) other[k] = __shfl_xor_sync(kFullMask, acc[k], o);
    int arg_other = __shfl_xor_sync(kFullMask, *arg, o);
    max_pair<N, kVal>(acc, arg, other, arg_other);
  }
}

// The passes a warp makes: the most that any of its rays needs (each lane
// gives its ray's count), so that every lane takes part in every pass's
// hand-over.
__device__ __forceinline__ int warp_passes(int passes) {
  return (int)__reduce_max_sync(kFullMask, (unsigned)passes);
}
#endif

}  // namespace lanes
