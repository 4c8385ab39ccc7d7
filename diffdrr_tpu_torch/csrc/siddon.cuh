// Exact Siddon line integrals by slab march: the per-ray arithmetic.
//
// Shared by the CUDA kernels in siddon.cu and by any host build (the
// SIDDON_HD macro is empty without nvcc), so the kernels' own arithmetic can
// be compiled and checked on a machine without a GPU.
//
// Geometry (see diffdrr_tpu_torch/ops/kernels/prep.py for the rows): the
// volume is read through its strides in (s, y, z) order, s being the march
// axis, or (trace_fwd, max_slabs, fused_terms) through its bricked copy in
// the same order (brick.cuh). Slab s covers s-positions [s - 0.5, s + 0.5],
// i.e. the alpha interval between (s -/+ 0.5) a + b, clipped to the ray's
// [amin, amax]. When the ray's transverse slopes are at most 1 in voxel
// units (the DRR checks this), the ray crosses at most one y-boundary and
// one z-boundary inside a slab, so the slab holds at most three segments
// whose nearest voxels lie in a 2x2 neighbourhood. The value is
// sum_j len_j * w * V_j; a voxel index outside the volume reads 0.
//
// Every expression below follows diffdrr_tpu/ops/pallas/siddon.py
// (_slab_segments, _fwd_kernel, _fwdgrad_kernel, _bwd_rays_kernel and
// _bwd_vol_kernel) operation for operation, in float32, with rintf for
// jnp.round (both round half to even).
//
// MIP (reducefn="max"): the value is the largest len_j * w * V_j over the
// ray's segments, and the argmax codes the winning segment as slab * 4 +
// segment (-1 when no segment beats 0). Every other segment's gradient is
// gated to zero, so a MIP backward only has to visit the argmax slab (one
// thread per ray). The forward splits a ray over G lanes, each the first
// maximum of its slabs, combined in lanes.cuh's tree (fwd_max_lanes): the
// serial first maximum.
#pragma once

#include <math.h>
#include <stdint.h>

#include "brick.cuh"
#include "lanes.cuh"

#if defined(__CUDACC__)
#define SIDDON_HD __host__ __device__ __forceinline__
#else
#define SIDDON_HD inline
#endif

namespace siddon {

// Packed input rows are (9, R) row-major: a b gy dy gz dz sc amin amax.
// Fused output rows, (10, R): the 9 gradient rows in input order, then the value.
constexpr int kRows = 9;
constexpr int kFusedRows = 10;
constexpr int kValueRow = 9;

struct Volume {
  const float* data;
  int64_t ss, sy, sz;  // element strides of the permuted (s, y, z) axes
  int X, Y, Z;         // extents of the permuted axes
};

// The density gradient, read through its own strides in the same (s, y, z)
// order, so it lands in the density's layout.
struct GradVolume {
  float* data;
  int64_t ss, sy, sz;
  int X, Y, Z;
};

struct Ray {
  float a, b, gy, dy, gz, dz, w, amin, amax;
};

struct Slab {
  float alo, ahi, ahi_raw, a1, a2, ty, tz, y0, z0;
  float len[3];
  float iy[3], iz[3];  // 0/1 selectors of each segment's voxel in the 2x2
};

SIDDON_HD Ray load_ray(const float* rows, int64_t n_rays, int64_t r) {
  Ray o;
  o.a = rows[0 * n_rays + r];
  o.b = rows[1 * n_rays + r];
  o.gy = rows[2 * n_rays + r];
  o.dy = rows[3 * n_rays + r];
  o.gz = rows[4 * n_rays + r];
  o.dz = rows[5 * n_rays + r];
  o.w = rows[6 * n_rays + r];
  o.amin = rows[7 * n_rays + r];
  o.amax = rows[8 * n_rays + r];
  return o;
}

SIDDON_HD float safe_div_d(float d) { return fabsf(d) < 1e-20f ? 1e-20f : d; }

SIDDON_HD float clip(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// Voxel at slab s and integer-valued transverse positions (fy, fz); 0 outside.
SIDDON_HD float voxel(const Volume& v, int s, float fy, float fz) {
  if (!(fy >= 0.f && fy < (float)v.Y && fz >= 0.f && fz < (float)v.Z)) return 0.f;
  return v.data[(int64_t)s * v.ss + (int64_t)fy * v.sy + (int64_t)fz * v.sz];
}

// The same voxel of the bricked copy (brick.cuh), by the same bounds test.
template <int A, class T>
SIDDON_HD float voxel(const brick::Volume<A, T>& v, int s, float fy, float fz) {
  if (!(fy >= 0.f && fy < (float)v.Y && fz >= 0.f && fz < (float)v.Z)) return 0.f;
  return brick::load(v.data + brick::offset(v, s, (int)fy, (int)fz));
}

// Base voxel and crossing alpha of one transverse axis inside [alo, ahi].
SIDDON_HD void crossing(float g, float d, float alo, float ahi, float* base, float* t) {
  float m_lo = rintf(g + alo * d);
  float m_hi = rintf(g + ahi * d);
  *base = fminf(m_lo, m_hi);
  float bound = fmaxf(m_lo, m_hi) - 0.5f;
  float ac = (bound - g) / safe_div_d(d);
  *t = (m_lo != m_hi) ? clip(ac, alo, ahi) : alo;
}

SIDDON_HD Slab slab_segments(const Ray& r, int s) {
  Slab o;
  float sf = (float)s;
  o.a1 = (sf - 0.5f) * r.a + r.b;
  o.a2 = (sf + 0.5f) * r.a + r.b;
  float alo = fmaxf(fminf(o.a1, o.a2), r.amin);
  o.ahi_raw = fminf(fmaxf(o.a1, o.a2), r.amax);
  float ahi = fmaxf(o.ahi_raw, alo);  // empty intersection -> zero length
  o.alo = alo;
  o.ahi = ahi;
  crossing(r.gy, r.dy, alo, ahi, &o.y0, &o.ty);
  crossing(r.gz, r.dz, alo, ahi, &o.z0, &o.tz);
  float t1 = fminf(o.ty, o.tz);
  float t2 = fmaxf(o.ty, o.tz);
  o.len[0] = t1 - alo;
  o.len[1] = t2 - t1;
  o.len[2] = ahi - t2;
  float mid[3] = {(alo + t1) * 0.5f, (t1 + t2) * 0.5f, (t2 + ahi) * 0.5f};
  for (int j = 0; j < 3; ++j) {
    o.iy[j] = clip(rintf(r.gy + mid[j] * r.dy) - o.y0, 0.f, 1.f);
    o.iz[j] = clip(rintf(r.gz + mid[j] * r.dz) - o.z0, 0.f, 1.f);
  }
  return o;
}

// Slabs [lo, hi) that can meet the ray's [amin, amax], with one slab of
// margin on each side. Slabs outside the interval are empty and add exact
// zeros (value and gradient rows alike), so the margin changes nothing; it
// only guards the partially entered first and last slabs against rounding.
SIDDON_HD void slab_range(const Ray& r, int X, int* lo, int* hi) {
  float u0 = (r.amin - r.b) / r.a;
  float u1 = (r.amax - r.b) / r.a;
  float flo = floorf(fminf(u0, u1) + 0.5f) - 1.f;
  float fhi = floorf(fmaxf(u0, u1) + 0.5f) + 2.f;
  // fmaxf/fminf return the number for a NaN operand: a NaN ray walks all slabs.
  *lo = (int)fminf(fmaxf(flo, 0.f), (float)X);
  *hi = (int)fminf(fmaxf(fhi, 0.f), (float)X);
}

// The loads siddon_fwd keeps in flight: the segments of this many slabs,
// on a float32 copy and on a bf16 one alike.
constexpr int kFwdSlabs = 4;

// The voxel that voxel() reads from a bf16 copy, as the copy stores it: its
// 16 bits, by the same bounds test; zero bits outside (+0.0 widened, as
// voxel's 0).
template <int A>
SIDDON_HD brick::bf16 voxel_raw(const brick::Volume<A, brick::bf16>& v, int s, float fy,
                                float fz) {
  if (!(fy >= 0.f && fy < (float)v.Y && fz >= 0.f && fz < (float)v.Z)) return 0;
  return brick::load_raw(v.data + brick::offset(v, s, (int)fy, (int)fz));
}

// trace_fwd's read of segment j of slab s (sl its segments, hi the end of
// the ray's slabs), as the volume stores it: voxel()'s float, or on a bf16
// copy the 16 bits (voxel_raw), left raw for the sums to widen. A slab past
// hi or a zero-length segment (which adds 0 * V) reads nothing: 0, or zero
// bits.
template <class Vol>
SIDDON_HD float read_raw(const Vol& v, int s, int hi, const Slab& sl, int j) {
  return (s < hi && sl.len[j] > 0.f) ? voxel(v, s, sl.y0 + sl.iy[j], sl.z0 + sl.iz[j]) : 0.f;
}

template <int A>
SIDDON_HD brick::bf16 read_raw(const brick::Volume<A, brick::bf16>& v, int s, int hi,
                               const Slab& sl, int j) {
  return (s < hi && sl.len[j] > 0.f) ? voxel_raw(v, s, sl.y0 + sl.iy[j], sl.z0 + sl.iz[j])
                                     : (brick::bf16)0;
}

// sum over slabs of w * (len1 V1 + len2 V2 + len3 V3), from the strided
// density (Volume) or its bricked copy (brick::Volume). U slabs at a time:
// their segments and reads first, so up to 3U loads are in flight, then
// their sums in slab order, so the value is bit for bit the U = 1 one. The
// reads stay as the volume stores them (read_raw) until the sums widen
// them, so a bf16 copy's 3U loads are in flight together too, and its sums
// are the float32 ones on the density rounded to bf16.
template <int U = 1, class Vol>
SIDDON_HD float trace_fwd(const Ray& r, const Vol& v) {
  using E = decltype(read_raw(v, 0, 0, Slab(), 0));
  int lo, hi;
  slab_range(r, v.X, &lo, &hi);
  float acc = 0.f;
  for (int s0 = lo; s0 < hi; s0 += U) {
    float len[U][3];
    E V[U][3];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int s = s0 + u;
      Slab sl = slab_segments(r, s);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        len[u][j] = sl.len[j];
        V[u][j] = read_raw(v, s, hi, sl, j);
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

// Routes d(value)/d(t) of one crossing: to g and d when the crossing is
// interior to [alo, ahi], else to the clamped end (alo or ahi).
SIDDON_HD void route(float t, float d_t, float d_pos, float alo, float ahi,
                     float* d_g, float* d_d, float* d_lo, float* d_hi) {
  bool interior = (t > alo) && (t < ahi);
  bool at_hi = t >= ahi;
  float sd = safe_div_d(d_pos);
  *d_g = interior ? d_t * (-1.0f / sd) : 0.f;
  *d_d = interior ? d_t * (-t / sd) : 0.f;
  *d_lo = (!interior && !at_hi) ? d_t : 0.f;
  *d_hi = at_hi ? d_t : 0.f;
}

// MIP: the largest len_j * w * V_j and its code s * 4 + j. A strict > keeps
// the first maximum in slab, then segment, order; the running max starts at
// 0 and the code at -1, so a ray that never beats 0 has no gradient. A
// zero-length segment gives 0, which cannot beat the running max: skip its
// read and its compare.
//
// The running first maximum (*best, *best_arg) taken over the U slabs s0,
// s0 + step, ..., s0 + (U - 1) step below hi, from the strided density
// (Volume) or its bricked copy (brick::Volume): their segments and reads
// first (up to 3U loads in flight), then the compares in slab, then
// segment, order.
template <int U, class Vol>
SIDDON_HD void max_slabs(const Ray& r, const Vol& v, int s0, int step, int hi, float* best,
                         int* best_arg) {
  float x[U][3];
  bool ok[U][3];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int s = s0 + u * step;
    Slab sl = slab_segments(r, s);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      ok[u][j] = s < hi && sl.len[j] > 0.f;
      float V = ok[u][j] ? voxel(v, s, sl.y0 + sl.iy[j], sl.z0 + sl.iz[j]) : 0.f;
      x[u][j] = sl.len[j] * r.w * V;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (ok[u][j] && x[u][j] > *best) {
        *best = x[u][j];
        *best_arg = (s0 + u * step) * 4 + j;
      }
    }
  }
}

// The MIP value and code of one ray, U slabs at a time (max_slabs): the
// same bits and code whatever U.
template <int U = 1, class Vol>
SIDDON_HD void trace_fwd_max(const Ray& r, const Vol& v, float* val, int* arg) {
  int lo, hi;
  slab_range(r, v.X, &lo, &hi);
  float best = 0.f;
  int best_arg = -1;
  for (int s0 = lo; s0 < hi; s0 += U) max_slabs<U>(r, v, s0, 1, hi, &best, &best_arg);
  *val = best;
  *arg = best_arg;
}

// siddon_fwd_max's lanes a ray (G) and the slabs a lane keeps in flight
// (U), from max_channel_timing.py's probes (siddon.cu says why these).
constexpr int kMaxLanes = 8;
constexpr int kMaxSlabs = 1;

#if defined(__CUDACC__)
// Thread t's part in siddon_fwd_max (and the probes): lane t % G of ray
// t / G takes the slabs lo + lane, lo + lane + G, ... (U at a time,
// max_slabs), keeping the first maximum of its own slabs; the ray's lanes
// then combine in lanes.cuh's tree, the larger value winning and of two
// equal ones the smaller code, which is the serial first maximum. Lane 0
// writes the value to out[r] and the code to arg[r]. Every thread of a
// warp must call this (those of rays past the end too): the tree shuffles.
template <int G, int U, class Vol>
__device__ __forceinline__ void fwd_max_lanes(const float* __restrict__ rows, int64_t n_rays,
                                              const Vol& v, float* __restrict__ out,
                                              int* __restrict__ arg, int64_t t) {
  int64_t r = t / G;
  int lane = (int)(t % G);
  bool live = r < n_rays;
  Ray ray{};
  int lo = 0, hi = 0;
  if (live) {
    ray = load_ray(rows, n_rays, r);
    slab_range(ray, v.X, &lo, &hi);
  }
  float best[1] = {0.f};
  int best_arg = -1;
  for (int s0 = lo + lane; s0 < hi; s0 += G * U)
    max_slabs<U>(ray, v, s0, G, hi, best, &best_arg);
  lanes::combine_max_warp<G, 1, 0>(best, &best_arg);
  if (live && lane == 0) {
    out[r] = best[0];
    arg[r] = best_arg;
  }
}
#endif

// Adds slab s's d(value)/d(row) to acc[0..8] for the segment values V (the
// voxel values, or in MIP those gated to the argmax segment) and returns
// sum_j V_j len_j.
SIDDON_HD float slab_rows(const Ray& r, const Slab& sl, int s, const float V[3], float acc[]) {
  float w = r.w;
  float d_t1 = w * (V[0] - V[1]);
  float d_t2 = w * (V[1] - V[2]);
  float d_alo = -w * V[0];
  float d_ahi = w * V[2];

  bool ty_is_min = sl.ty <= sl.tz;
  float d_ty = ty_is_min ? d_t1 : d_t2;
  float d_tz = ty_is_min ? d_t2 : d_t1;
  float d_gy, d_dy, d_alo_y, d_ahi_y, d_gz, d_dz, d_alo_z, d_ahi_z;
  route(sl.ty, d_ty, r.dy, sl.alo, sl.ahi, &d_gy, &d_dy, &d_alo_y, &d_ahi_y);
  route(sl.tz, d_tz, r.dz, sl.alo, sl.ahi, &d_gz, &d_dz, &d_alo_z, &d_ahi_z);
  float d_alo_tot = d_alo + d_alo_y + d_alo_z;
  float d_ahi_tot = d_ahi + d_ahi_y + d_ahi_z;

  // alo comes from a slab plane (a1 or a2) when interior, else from amin;
  // ahi likewise from a plane or amax. An empty slab (ahi clamped to alo)
  // routes its ahi term through alo, where it cancels.
  bool empty = sl.ahi_raw < sl.alo;
  float d_alo_eff = d_alo_tot + (empty ? d_ahi_tot : 0.f);
  float d_ahi_eff = empty ? 0.f : d_ahi_tot;
  bool lo_is_a1 = sl.a1 <= sl.a2;
  bool lo_interior = sl.alo > r.amin;
  bool hi_interior = sl.ahi_raw < r.amax;
  float d_a1 = ((lo_is_a1 && lo_interior) ? d_alo_eff : 0.f) +
               ((!lo_is_a1 && hi_interior) ? d_ahi_eff : 0.f);
  float d_a2 = ((!lo_is_a1 && lo_interior) ? d_alo_eff : 0.f) +
               ((lo_is_a1 && hi_interior) ? d_ahi_eff : 0.f);

  float sf = (float)s;
  float seg = V[0] * sl.len[0] + V[1] * sl.len[1] + V[2] * sl.len[2];
  acc[0] += d_a1 * (sf - 0.5f) + d_a2 * (sf + 0.5f);
  acc[1] += d_a1 + d_a2;
  acc[2] += d_gy;
  acc[3] += d_dy;
  acc[4] += d_gz;
  acc[5] += d_dz;
  acc[6] += seg;
  acc[7] += lo_interior ? 0.f : d_alo_eff;
  acc[8] += hi_interior ? 0.f : d_ahi_eff;
  return seg;
}

// The fused march: acc[0..8] += d(value)/d(row), acc[9] += value. The rows
// do not depend on the output cotangent, so the backward is rows * g. One
// thread per ray, slab after slab: the order of sums that fwdgrad_lanes
// keeps.
SIDDON_HD void trace_fwdgrad(const Ray& r, const Volume& v, float acc[kFusedRows]) {
  for (int k = 0; k < kFusedRows; ++k) acc[k] = 0.f;
  int lo, hi;
  slab_range(r, v.X, &lo, &hi);
  for (int s = lo; s < hi; ++s) {
    Slab sl = slab_segments(r, s);
    float V[3];
    for (int j = 0; j < 3; ++j) V[j] = voxel(v, s, sl.y0 + sl.iy[j], sl.z0 + sl.iz[j]);
    float seg = slab_rows(r, sl, s, V, acc);
    acc[kValueRow] += r.w * seg;
  }
}

// siddon_fwdgrad's lanes a ray (G), the slabs a lane keeps in flight (U)
// and its threads a block (siddon.cu says why these); kFusedSlabsOf<T> on a
// copy of element T, a bf16 one's its own (the probes chose the same).
constexpr int kFusedLanes = 8;
constexpr int kFusedSlabs = 1;
constexpr int kFusedThreads = 128;
template <class T>
constexpr int kFusedSlabsOf = kFusedSlabs;
template <>
constexpr int kFusedSlabsOf<brick::bf16> = 1;

// fused_terms' read of segment j of slab s (sl its segments, hi the end of
// the ray's slabs), as the volume stores it: voxel()'s float, or on a bf16
// copy the 16 bits (voxel_raw), left raw for the rows to widen; 0, or zero
// bits, for a slab at or past hi. Unlike read_raw, a zero-length segment is
// read: its value enters the crossings' terms (slab_rows).
template <class Vol>
SIDDON_HD float segment_raw(const Vol& v, int s, int hi, const Slab& sl, int j) {
  return s < hi ? voxel(v, s, sl.y0 + sl.iy[j], sl.z0 + sl.iz[j]) : 0.f;
}

template <int A>
SIDDON_HD brick::bf16 segment_raw(const brick::Volume<A, brick::bf16>& v, int s, int hi,
                                  const Slab& sl, int j) {
  return s < hi ? voxel_raw(v, s, sl.y0 + sl.iy[j], sl.z0 + sl.iz[j]) : (brick::bf16)0;
}

// The fused march's summands of U slabs s0, s0 + step, ...,
// s0 + (U - 1) step: t[u][0..8] the slab's d(value)/d(row) and t[u][9] its
// value, the terms trace_fwdgrad adds (slab_rows into zeros: the same bits
// once added); all 0 for a slab at or past hi, slab_range's end. Their
// segments and reads first (3U loads in flight), then their rows. The reads
// stay as the volume stores them (segment_raw) until every one of them has
// issued, so a bf16 copy's 3U 16-bit loads are in flight together too; each
// is then widened, exactly, and the rows are the float32 ones on the
// density rounded to bf16.
template <int U, class Vol>
SIDDON_HD void fused_terms(const Ray& r, const Vol& v, int s0, int step, int hi,
                           float t[U][kFusedRows]) {
  using E = decltype(segment_raw(v, 0, 0, Slab(), 0));
  Slab sl[U];
  E raw[U][3];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int s = s0 + u * step;
    sl[u] = slab_segments(r, s);
#pragma unroll
    for (int j = 0; j < 3; ++j) raw[u][j] = segment_raw(v, s, hi, sl[u], j);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int k = 0; k < kFusedRows; ++k) t[u][k] = 0.f;
    int s = s0 + u * step;
    if (s < hi) {
      float V[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) V[j] = brick::widen(raw[u][j]);
      float seg = slab_rows(r, sl[u], s, V, t[u]);
      t[u][kValueRow] = r.w * seg;
    }
  }
}

// siddon_bwd_rays' lanes a ray (G) and slabs a lane keeps in flight (U) in
// sum mode, from max_rays_timing.py's probes (siddon.cu says why these).
constexpr int kBwdLanes = 8;
constexpr int kBwdSlabs = 1;

#if defined(__CUDACC__)
// Thread t's part in a fused launch of G lanes a ray and U slabs in flight
// a lane (siddon_fwdgrad, siddon_bwd_rays' sum mode, and the probes), from
// the strided density or its bricked copy: lane t % G of ray t / G, in
// passes of G * U slabs (lanes.cuh), lane k % G writing row k of out
// (N, n_rays): the fused march's first N rows (fused_terms), all 10 for
// siddon_fwdgrad, or the 9 gradient rows each times g[r] once they are
// summed when g is given (siddon_bwd_rays: trace_bwd_rays' rows, bit for
// bit). Blocks of kFusedThreads; every thread of a warp must call this
// (those of rays past the end too): the passes hand summands over through
// the warp's shared memory. A warp holds 32 / G whole rays.
template <int G, int U, int N = kFusedRows, class Vol>
__device__ __forceinline__ void fwdgrad_lanes(const float* __restrict__ rows, int64_t n_rays,
                                              const Vol& v, float* __restrict__ out, int64_t t,
                                              const float* __restrict__ g = nullptr) {
  constexpr int kSlabs = G * U;       // a ray's slabs a pass
  constexpr int kStride = 32 * U + 1;  // a row of the warp's hand-over (+1: no bank conflicts)
  __shared__ float hand[kFusedThreads / 32][N * kStride];
  int64_t r = t / G;
  int lane = (int)(t % G);
  bool live = r < n_rays;
  Ray ray{};
  int lo = 0, hi = 0;
  if (live) {
    ray = load_ray(rows, n_rays, r);
    slab_range(ray, v.X, &lo, &hi);
  }
  int passes = lanes::warp_passes((hi - lo + kSlabs - 1) / kSlabs);
  float* mine = hand[threadIdx.x / 32] + (threadIdx.x % 32) / G * kSlabs;  // the ray's columns
  float acc[lanes::kSlots<G, N>] = {};
  for (int p = 0; p < passes; ++p) {
    float tm[U][kFusedRows];
    fused_terms<U>(ray, v, lo + p * kSlabs + lane, G, hi, tm);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < N; ++k) mine[k * kStride + u * G + lane] = tm[u][k];
    __syncwarp();
    lanes::take_in_order<G, N, kSlabs>(mine, kStride, lane, acc);
    __syncwarp();
  }
  if (!live) return;
  float gr = g ? g[r] : 0.f;
#pragma unroll
  for (int slot = 0; slot < lanes::kSlots<G, N>; ++slot) {
    int k = lane + slot * G;
    if (k < N) out[k * n_rays + r] = g ? acc[slot] * gr : acc[slot];
  }
}
#endif

// The two-pass pose backward: acc[0..8] = g * d(value)/d(row), from the
// strided density (Volume) or, in the probes, its bricked copy
// (brick::Volume), slab after slab (the order of sums that fwdgrad_lanes
// keeps), then one product by g.
// In MIP mode only the argmax slab carries a gradient (none when arg is
// -1), and inside it V is gated to the argmax segment before any term is
// formed, the boundary terms d_alo = -w V1 and d_ahi = w V3 included.
template <class Vol>
SIDDON_HD void trace_bwd_rays(const Ray& r, const Vol& v, float g, int arg, bool mip,
                              float acc[kRows]) {
  for (int k = 0; k < kRows; ++k) acc[k] = 0.f;
  int lo, hi;
  if (mip) {
    if (arg < 0 || arg / 4 >= v.X) return;  // no maximum, or not a slab of v
    lo = arg / 4;
    hi = lo + 1;
  } else {
    slab_range(r, v.X, &lo, &hi);
  }
  for (int s = lo; s < hi; ++s) {
    Slab sl = slab_segments(r, s);
    float V[3];
    for (int j = 0; j < 3; ++j) {
      V[j] = voxel(v, s, sl.y0 + sl.iy[j], sl.z0 + sl.iz[j]);
      if (mip && arg != s * 4 + j) V[j] = 0.f;
    }
    slab_rows(r, sl, s, V, acc);
  }
  for (int k = 0; k < kRows; ++k) acc[k] *= g;
}

// One write of the density gradient: an atomic add on the device, where
// many rays may hit one voxel at once; a plain add in a serial host build.
SIDDON_HD void add_grad(float* p, float x) {
#if defined(__CUDA_ARCH__)
  atomicAdd(p, x);
#else
  *p += x;
#endif
}

// The most adds one slab makes to the density gradient: one per segment.
constexpr int kSlabAdds = 3;

// Slab s's share of d(loss)/d(volume): len_j * w * g onto each non-empty
// segment's voxel (s, y0 + iy_j, z0 + iz_j) inside the volume; in MIP mode
// only onto the argmax segment's. Returns the mask of the segments that add
// (bit j for segment j) and, for each of them, the voxel's element offset
// into gv.data in off[j] and the value in x[j]. Zero-length segments (the
// slab range's margin, empty slabs) add nothing. A pure function of the ray
// and s, so the slabs of one ray can be scattered in any order, by any
// thread.
SIDDON_HD unsigned slab_adds(const Ray& r, const GradVolume& gv, int s, float g, int arg,
                             bool mip, int64_t off[kSlabAdds], float x[kSlabAdds]) {
  Slab sl = slab_segments(r, s);
  unsigned mask = 0u;
  for (int j = 0; j < kSlabAdds; ++j) {
    if (!(sl.len[j] > 0.f) || (mip && arg != s * 4 + j)) continue;
    float fy = sl.y0 + sl.iy[j];
    float fz = sl.z0 + sl.iz[j];
    if (!(fy >= 0.f && fy < (float)gv.Y && fz >= 0.f && fz < (float)gv.Z)) continue;
    off[j] = (int64_t)s * gv.ss + (int64_t)fy * gv.sy + (int64_t)fz * gv.sz;
    x[j] = sl.len[j] * r.w * g;
    mask |= 1u << j;
  }
  return mask;
}

// The slabs [lo, hi) whose segments d(loss)/d(volume) visits: the slab
// range, or in MIP mode only the argmax slab (none when arg is -1).
SIDDON_HD void scatter_range(const Ray& r, int X, int arg, bool mip, int* lo, int* hi) {
  if (!mip) {
    slab_range(r, X, lo, hi);
  } else if (arg < 0 || arg / 4 >= X) {  // no maximum, or not a slab of the volume
    *lo = *hi = 0;
  } else {
    *lo = arg / 4;
    *hi = *lo + 1;
  }
}

// d(loss)/d(volume) of one ray, slab after slab (the serial order; the
// kernel spreads the same slab_adds calls over a warp's lanes).
SIDDON_HD void trace_bwd_vol(const Ray& r, const GradVolume& gv, float g, int arg, bool mip) {
  int lo, hi;
  scatter_range(r, gv.X, arg, mip, &lo, &hi);
  int64_t off[kSlabAdds];
  float x[kSlabAdds];
  for (int s = lo; s < hi; ++s) {
    unsigned mask = slab_adds(r, gv, s, g, arg, mip, off, x);
    for (int j = 0; j < kSlabAdds; ++j)
      if (mask >> j & 1u) add_grad(gv.data + off[j], x[j]);
  }
}

}  // namespace siddon
