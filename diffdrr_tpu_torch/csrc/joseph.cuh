// Joseph plane march and trilinear ray march: the per-ray, per-step arithmetic.
//
// Shared by the CUDA kernels in joseph.cu and by any host build (the
// JOSEPH_HD macro is empty without nvcc), so the kernels' own arithmetic can
// be compiled and checked on a machine without a GPU.
//
// Geometry (the rows are packed by diffdrr_tpu_torch/ops/kernels/prep.py with
// the Joseph quadrature): the volume is read through its strides in (s, y, z)
// order, s being the march axis, or (trace_fwd, max_steps, fused_terms,
// channel_samples, channel_terms) through its bricked copy in the same
// order (brick.cuh). Step p samples the ray at axis position k = p * h,
// where alpha = k * a + b and the transverse position is
// (gy + alpha dy, gz + alpha dz). The sample counts only inside the ray's
// [amin, amax] (clamped to [0, 1]) and is weighted by sc = w |1/d_s| h.
//
//   * integer h: a bilinear sample of plane p * h;
//   * fractional h (the trilinear ray march): the lerp, by fx = k - k0, of
//     planes k0 = clamp(floor(k), 0, X - 1) and k0 + 1, sampled bilinearly
//     (plane X reads 0).
//
// The bilinear sample uses tent weights max(0, 1 - |u|) over the 2 x 2
// in-plane neighbours (floor, floor + 1) of the position; a neighbour outside
// the volume reads 0. Its derivatives are the tent derivative -sign(u) on
// |u| < 1, with subgradient 0 at the kinks (diffdrr_tpu/ops/pallas/joseph.py
// _tent_d), so at exact grid positions they differ from a floor-based
// bilinear derivative: compare gradients at off-grid poses.
//
// Every expression follows the TPU kernels of diffdrr_tpu/ops/pallas/joseph.py
// (_plane_geometry, _blend_win, _fwd_kernel, _fwdgrad_kernel,
// _bwd_rays_kernel, _bwd_vol_kernel), in float32: the sums over z first
// (t4 = win @ tent(uz), t3 = win @ tent'(uz)), then over y.
//
// MIP (reducefn="max"): the value is the largest sample * sc over the ray's
// steps, the argmax is the step p (-1 when no sample beats 0), and every
// gradient is gated to that step. The forward splits a ray over G lanes,
// each the first maximum of its steps, combined in lanes.cuh's tree
// (fwd_max_lanes): the serial first maximum.
//
// Channels (mask_to_channels): each step also reads the labelmap at the
// sample's nearest voxel (label_at) and lands in that label's channel; a
// label outside [0, C) adds nothing. The forward adds the step's value to
// its channel (fwd_ch_lanes: G lanes a ray, the ray's sums in shared
// memory, the last sample's in a register, in trace_fwd_ch's order), and
// both backwards take the cotangent of that channel for the step. Channel
// renders are always sums. Each step's share of either backward is a pure
// function of the ray and the step (channel_terms, step_adds_ch_at), so
// the kernels split a ray as the scalar ones do: the pose backward over G
// lanes in the serial order of sums (bwd_rays_ch_lanes), the scatter over
// a warp. The forward and the pose backward read the bricked copies of the
// density and the labelmap.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "brick.cuh"
#include "lanes.cuh"

#if defined(__CUDACC__)
#define JOSEPH_HD __host__ __device__ __forceinline__
#else
#define JOSEPH_HD inline
#endif

namespace joseph {

// Packed input rows are (9, R) row-major: a b gy dy gz dz sc amin amax.
// Gradient rows, (7, R): d(value)/d(a b gy dy gz dz sc); amin and amax get
// none (they enter only through the in-slab comparison). Fused output rows,
// (8, R): the 7 gradient rows, then the value.
constexpr int kRows = 7;
constexpr int kFusedRows = 8;
constexpr int kValueRow = 7;

struct Volume {
  const float* data;
  int64_t ss, sy, sz;  // element strides of the permuted (s, y, z) axes
  int X, Y, Z;         // extents of the permuted axes
};

// The density gradient, written through its own strides in the same order.
struct GradVolume {
  float* data;
  int64_t ss, sy, sz;
  int X, Y, Z;
};

// The labelmap (int32 structure IDs), read through its own strides in the
// density's permuted order; its extents are the density's.
struct Labels {
  const int* data;
  int64_t ss, sy, sz;
  int X, Y, Z;
};

struct Ray {
  float a, b, gy, dy, gz, dz, sc, amin, amax;
};

// The march: n_steps samples at k = p * h; blend when h is fractional.
struct March {
  float h;
  int n_steps;
  bool blend;
};

// One step of one ray.
struct Step {
  float k, alpha, scale;
  bool inslab;
  int k0;    // the plane (integer h) or the first of the pair (blend)
  float fx;  // the pair's lerp fraction (blend)
  float fy, fz;  // floor of the transverse position (integer-valued)
  float wy[2], wz[2];  // tent weights of the neighbours floor and floor + 1
};

JOSEPH_HD Ray load_ray(const float* rows, int64_t n_rays, int64_t r) {
  Ray o;
  o.a = rows[0 * n_rays + r];
  o.b = rows[1 * n_rays + r];
  o.gy = rows[2 * n_rays + r];
  o.dy = rows[3 * n_rays + r];
  o.gz = rows[4 * n_rays + r];
  o.dz = rows[5 * n_rays + r];
  o.sc = rows[6 * n_rays + r];
  o.amin = rows[7 * n_rays + r];
  o.amax = rows[8 * n_rays + r];
  return o;
}

JOSEPH_HD float tent(float u) { return fmaxf(0.f, 1.f - fabsf(u)); }

// d/du max(0, 1 - |u|): -sign(u) on |u| < 1, 0 at u = 0 and outside.
JOSEPH_HD float tent_d(float u) {
  if (!(fabsf(u) < 1.f)) return 0.f;
  return u > 0.f ? -1.f : (u < 0.f ? 1.f : 0.f);
}

JOSEPH_HD Step step_at(const Ray& r, const March& m, int X, int p) {
  Step s;
  s.k = (float)p * m.h;
  s.alpha = s.k * r.a + r.b;
  s.inslab = s.alpha >= r.amin && s.alpha <= r.amax;
  s.scale = s.inslab ? r.sc : 0.f;
  if (m.blend) {
    float k0 = fminf(fmaxf(floorf(s.k), 0.f), (float)(X - 1));
    s.k0 = (int)k0;
    s.fx = s.k - k0;
  } else {
    s.k0 = p * (int)rintf(m.h);
    s.fx = 0.f;
  }
  float y = r.gy + s.alpha * r.dy;
  float z = r.gz + s.alpha * r.dz;
  s.fy = floorf(y);
  s.fz = floorf(z);
  float uy = y - s.fy;
  float uz = z - s.fz;
  s.wy[0] = tent(uy);
  s.wy[1] = tent(uy - 1.f);
  s.wz[0] = tent(uz);
  s.wz[1] = tent(uz - 1.f);
  return s;
}

// Tent derivatives of the neighbours, recomputed from the weights' inputs.
JOSEPH_HD void tent_derivs(const Ray& r, const Step& s, float dy[2], float dz[2]) {
  float uy = (r.gy + s.alpha * r.dy) - s.fy;
  float uz = (r.gz + s.alpha * r.dz) - s.fz;
  dy[0] = tent_d(uy);
  dy[1] = tent_d(uy - 1.f);
  dz[0] = tent_d(uz);
  dz[1] = tent_d(uz - 1.f);
}

// Voxel at plane k and integer-valued transverse position (fy, fz); 0 outside.
JOSEPH_HD float voxel(const Volume& v, int k, float fy, float fz) {
  if (!(k >= 0 && k < v.X && fy >= 0.f && fy < (float)v.Y && fz >= 0.f && fz < (float)v.Z))
    return 0.f;
  return v.data[(int64_t)k * v.ss + (int64_t)fy * v.sy + (int64_t)fz * v.sz];
}

// The same voxel of the bricked copy (brick.cuh), by the same bounds test.
template <int A, class T>
JOSEPH_HD float voxel(const brick::Volume<A, T>& v, int k, float fy, float fz) {
  if (!(k >= 0 && k < v.X && fy >= 0.f && fy < (float)v.Y && fz >= 0.f && fz < (float)v.Z))
    return 0.f;
  return brick::load(v.data + brick::offset(v, k, (int)fy, (int)fz));
}

// The 2 x 2 neighbourhood of the step (win[m][n] at y = fy + m, z = fz + n),
// lerped across the plane pair in blend mode.
template <class Vol>
JOSEPH_HD void window(const Vol& v, const Step& s, bool blend, float win[2][2]) {
  for (int m = 0; m < 2; ++m) {
    for (int n = 0; n < 2; ++n) {
      float fy = s.fy + (float)m;
      float fz = s.fz + (float)n;
      float w0 = voxel(v, s.k0, fy, fz);
      win[m][n] = blend ? w0 * (1.f - s.fx) + voxel(v, s.k0 + 1, fy, fz) * s.fx : w0;
    }
  }
}

// The bilinear sample sum_m wy_m sum_n win[m][n] wz_n (unscaled).
JOSEPH_HD float bilinear(const Step& s, const float win[2][2]) {
  float t4a = win[0][0] * s.wz[0] + win[0][1] * s.wz[1];
  float t4b = win[1][0] * s.wz[0] + win[1][1] * s.wz[1];
  return s.wy[0] * t4a + s.wy[1] * t4b;
}

// The step's sample times its scale: what trace_fwd adds and trace_fwd_max
// compares (0 outside the slab).
JOSEPH_HD float sample(const Step& s, const float win[2][2]) {
  return bilinear(s, win) * s.scale;
}

// The step's 7 terms d(value)/d(row) and its value contribution
// (_fwdgrad_kernel's body): dry = scale sum_m tent'(uy_m) t4_m,
// drz = scale sum_m wy_m t3_m, dsc = the unscaled sample inside the slab.
JOSEPH_HD float step_terms(const Ray& r, const Step& s, const float win[2][2],
                           float terms[kRows]) {
  float dy[2], dz[2];
  tent_derivs(r, s, dy, dz);
  float t4a = win[0][0] * s.wz[0] + win[0][1] * s.wz[1];
  float t4b = win[1][0] * s.wz[0] + win[1][1] * s.wz[1];
  float t3a = win[0][0] * dz[0] + win[0][1] * dz[1];
  float t3b = win[1][0] * dz[0] + win[1][1] * dz[1];
  float dry = (dy[0] * t4a + dy[1] * t4b) * s.scale;
  float drz = (s.wy[0] * t3a + s.wy[1] * t3b) * s.scale;
  float dsc = s.inslab ? s.wy[0] * t4a + s.wy[1] * t4b : 0.f;
  float dalpha = dry * r.dy + drz * r.dz;
  terms[0] = dalpha * s.k;
  terms[1] = dalpha;
  terms[2] = dry;
  terms[3] = dry * s.alpha;
  terms[4] = drz;
  terms[5] = drz * s.alpha;
  terms[6] = dsc;
  return dsc * s.scale;
}

// Steps [lo, hi) whose alpha can lie in [amin, amax], with one step of
// margin on each side. Steps outside the interval add exact zeros, so the
// margin changes nothing; it only guards the first and last in-slab steps
// against the rounding of this division. The in-slab test itself stays in
// the loop. A ray with a NaN bound marches no step.
JOSEPH_HD void step_range(const Ray& r, const March& m, int* lo, int* hi) {
  float ah = r.a * m.h;
  float u0 = (r.amin - r.b) / ah;
  float u1 = (r.amax - r.b) / ah;
  float flo = floorf(fminf(u0, u1)) - 1.f;
  float fhi = ceilf(fmaxf(u0, u1)) + 2.f;
  *lo = (int)fminf(fmaxf(flo, 0.f), (float)m.n_steps);
  *hi = (int)fminf(fmaxf(fhi, 0.f), (float)m.n_steps);
}

// The loads joseph_fwd keeps in flight: the windows of this many steps;
// kFwdStepsOf<T> on a copy of element T, a bf16 one's its own, and
// kFwdBlendSteps on the float32 copy in blend mode, its windows loaded raw
// (trace_fwd_raw; joseph.cu says why).
constexpr int kFwdSteps = 4;
template <class T>
constexpr int kFwdStepsOf = kFwdSteps;
template <>
constexpr int kFwdStepsOf<brick::bf16> = 2;
constexpr int kFwdBlendSteps = 2;

// sum over steps of sample * scale, from the strided density (Volume) or
// its float32 bricked copy (brick::Volume; a bf16 one has its own below).
// U steps at a time: their windows first, then their samples in step
// order, so the value is bit for bit the U = 1 one. window() lerps each
// plane pair as its loads land: in blend mode the thread waits on each
// pair in turn (trace_fwd_raw below does not).
template <int U = 1, class Vol>
JOSEPH_HD float trace_fwd(const Ray& r, const Vol& v, const March& m) {
  int lo, hi;
  step_range(r, m, &lo, &hi);
  float acc = 0.f;
  for (int p0 = lo; p0 < hi; p0 += U) {
    Step st[U];
    bool in[U];
    float win[U][2][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      st[u] = step_at(r, m, v.X, p0 + u);
      in[u] = p0 + u < hi && st[u].inslab;  // outside the slab: scale 0, the step adds 0
      if (in[u]) {
        window(v, st[u], m.blend, win[u]);
      } else {
        win[u][0][0] = win[u][0][1] = win[u][1][0] = win[u][1][1] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (in[u]) acc += sample(st[u], win[u]);
  }
  return acc;
}

// The step's window on a bricked copy as the copy stores it, where `read`:
// raw[q][m][n] the element (a float, or a bf16's 16 bits) of window's voxel
// at plane k0 + q, y = fy + m, z = fz + n, plane k0 + 1 only in blend mode,
// by voxel's bounds test (each plane's part once); zero (+0.0, or zero bits
// widened to +0.0: voxel's 0) outside the volume and where nothing is read.
// All of them are loaded before any is widened or lerped.
template <int A, class T>
JOSEPH_HD void window_raw(const brick::Volume<A, T>& v, const Step& s, bool blend, bool read,
                          T raw[2][2][2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    int k = s.k0 + q;
    bool plane = read && (q == 0 || blend) && k >= 0 && k < v.X;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float fy = s.fy + (float)m;
        float fz = s.fz + (float)n;
        bool ok = plane && fy >= 0.f && fy < (float)v.Y && fz >= 0.f && fz < (float)v.Z;
        raw[q][m][n] = ok ? brick::load_raw(v.data + brick::offset(v, k, (int)fy, (int)fz))
                          : (T)0;
      }
    }
  }
}

// window's 2 x 2 from window_raw's elements: each widened (the identity for
// a float), then lerped across the plane pair in blend mode by window's
// float32 operations in its order.
template <class T>
JOSEPH_HD void widen_window(const T raw[2][2][2], const Step& s, bool blend, float win[2][2]) {
  for (int m = 0; m < 2; ++m) {
    for (int n = 0; n < 2; ++n) {
      float w0 = brick::widen(raw[0][m][n]);
      win[m][n] = blend ? w0 * (1.f - s.fx) + brick::widen(raw[1][m][n]) * s.fx : w0;
    }
  }
}

// trace_fwd on a bricked copy (float32 or bf16) with its windows loaded raw:
// U steps' windows first (window_raw: 4U loads in flight, 8U in blend
// mode), then each widened and lerped (widen_window) and its sample added
// in step order. The same float32 operations on the same values as the
// strided serial march's, so the value is its value (on a bf16 copy: on
// the density rounded to bf16) bit for bit, whatever U.
template <int U = 1, int A, class T>
JOSEPH_HD float trace_fwd_raw(const Ray& r, const brick::Volume<A, T>& v, const March& m) {
  int lo, hi;
  step_range(r, m, &lo, &hi);
  float acc = 0.f;
  for (int p0 = lo; p0 < hi; p0 += U) {
    Step st[U];
    bool in[U];
    T raw[U][2][2][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      st[u] = step_at(r, m, v.X, p0 + u);
      in[u] = p0 + u < hi && st[u].inslab;  // outside the slab: scale 0, the step adds 0
      window_raw(v, st[u], m.blend, in[u], raw[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (in[u]) {
        float win[2][2];
        widen_window(raw[u], st[u], m.blend, win);
        acc += sample(st[u], win);
      }
    }
  }
  return acc;
}

// trace_fwd on a bf16 copy: its windows loaded raw in either mode (a read
// widened where it lands would make the thread wait on it there).
template <int U = 1, int A>
JOSEPH_HD float trace_fwd(const Ray& r, const brick::Volume<A, brick::bf16>& v,
                          const March& m) {
  return trace_fwd_raw<U>(r, v, m);
}

// MIP: the largest sample * scale and its step. A strict > keeps the first
// maximum; the running max starts at 0 and the step at -1, so a ray whose
// samples never beat 0 keeps -1. A step outside the slab samples 0, which
// cannot beat the running max: skip its reads and its compare.
//
// The running first maximum (*best, *best_p) taken over the U steps p0,
// p0 + step, ..., p0 + (U - 1) step below hi, from the strided density
// (Volume) or its bricked copy (brick::Volume): their windows first (4U
// loads in flight, 8U in blend mode), then the compares in step order.
template <int U, class Vol>
JOSEPH_HD void max_steps(const Ray& r, const Vol& v, const March& m, int p0, int step, int hi,
                         float* best, int* best_p) {
  Step st[U];
  bool in[U];
  float win[U][2][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    st[u] = step_at(r, m, v.X, p0 + u * step);
    in[u] = p0 + u * step < hi && st[u].inslab;
    if (in[u]) {
      window(v, st[u], m.blend, win[u]);
    } else {
      win[u][0][0] = win[u][0][1] = win[u][1][0] = win[u][1][1] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!in[u]) continue;
    float x = sample(st[u], win[u]);
    if (x > *best) {
      *best = x;
      *best_p = p0 + u * step;
    }
  }
}

// The MIP value and step of one ray, U steps at a time (max_steps): the
// same bits and step whatever U.
template <int U = 1, class Vol>
JOSEPH_HD void trace_fwd_max(const Ray& r, const Vol& v, const March& m, float* val, int* arg) {
  int lo, hi;
  step_range(r, m, &lo, &hi);
  float best = 0.f;
  int best_p = -1;
  for (int p0 = lo; p0 < hi; p0 += U) max_steps<U>(r, v, m, p0, 1, hi, &best, &best_p);
  *val = best;
  *arg = best_p;
}

// joseph_fwd_max's lanes a ray (G) and the steps a lane keeps in flight
// (U), from max_rays_timing.py's probes (joseph.cu says why these).
constexpr int kMaxLanes = 8;
constexpr int kMaxSteps = 1;

#if defined(__CUDACC__)
// Thread t's part in joseph_fwd_max (and the probes): lane t % G of ray
// t / G takes the steps lo + lane, lo + lane + G, ... (U at a time,
// max_steps), keeping the first maximum of its own steps; the ray's lanes
// then combine in lanes.cuh's tree, the larger value winning and of two
// equal ones the smaller step, which is the serial first maximum (-1 where
// no sample beats 0). Lane 0 writes the value to out[r] and the step to
// arg[r]. Every thread of a warp must call this (those of rays past the end
// too): the tree shuffles.
template <int G, int U, class Vol>
__device__ __forceinline__ void fwd_max_lanes(const float* __restrict__ rows, int64_t n_rays,
                                              const Vol& v, const March& m,
                                              float* __restrict__ out, int* __restrict__ arg,
                                              int64_t t) {
  int64_t r = t / G;
  int lane = (int)(t % G);
  bool live = r < n_rays;
  Ray ray{};
  int lo = 0, hi = 0;
  if (live) {
    ray = load_ray(rows, n_rays, r);
    step_range(ray, m, &lo, &hi);
  }
  float best[1] = {0.f};
  int best_p = -1;
  for (int p0 = lo + lane; p0 < hi; p0 += G * U)
    max_steps<U>(ray, v, m, p0, G, hi, best, &best_p);
  lanes::combine_max_warp<G, 1, 0>(best, &best_p);
  if (live && lane == 0) {
    out[r] = best[0];
    arg[r] = best_p;
  }
}
#endif

// The fused march: acc[0..6] = d(value)/d(row), acc[7] = value. In MIP mode
// the terms are replaced whenever a step beats the running max, and *arg
// gets the winning step. The rows do not depend on the output cotangent, so
// the backward is rows * g. One thread per ray, step after step: the order
// of sums that fwdgrad_lanes keeps, and its first maximum.
JOSEPH_HD void trace_fwdgrad(const Ray& r, const Volume& v, const March& m, bool mip,
                             float acc[kFusedRows], int* arg) {
  for (int i = 0; i < kFusedRows; ++i) acc[i] = 0.f;
  int best_p = -1;
  int lo, hi;
  step_range(r, m, &lo, &hi);
  for (int p = lo; p < hi; ++p) {
    Step s = step_at(r, m, v.X, p);
    if (!s.inslab) continue;  // every term is 0 outside the slab
    float win[2][2];
    window(v, s, m.blend, win);
    float terms[kRows];
    float contrib = step_terms(r, s, win, terms);
    if (mip) {
      if (contrib > acc[kValueRow]) {
        for (int i = 0; i < kRows; ++i) acc[i] = terms[i];
        acc[kValueRow] = contrib;
        best_p = p;
      }
    } else {
      for (int i = 0; i < kRows; ++i) acc[i] += terms[i];
      acc[kValueRow] += contrib;
    }
  }
  if (arg) *arg = best_p;
}

// joseph_fwdgrad's lanes a ray (G), the steps a lane keeps in flight (U)
// and its threads a block (joseph.cu says why these); kFusedStepsOf<T> on a
// copy of element T, a bf16 one's its own.
constexpr int kFusedLanes = 8;
constexpr int kFusedSteps = 1;
constexpr int kFusedThreads = 128;
template <class T>
constexpr int kFusedStepsOf = kFusedSteps;
template <>
constexpr int kFusedStepsOf<brick::bf16> = 2;

// The fused march's summands of U steps p0, p0 + step, ...,
// p0 + (U - 1) step: t[u][0..6] the step's 7 terms and t[u][7] its value
// contribution, what trace_fwdgrad adds (or, in MIP mode, compares); all 0
// for a step outside the slab or at or past hi, step_range's end. Their
// windows first (4U loads in flight, 8U in blend mode), then their terms.
template <int U, class Vol>
JOSEPH_HD void fused_terms(const Ray& r, const Vol& v, const March& m, int p0, int step, int hi,
                           float t[U][kFusedRows]) {
  Step st[U];
  bool in[U];
  float win[U][2][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    st[u] = step_at(r, m, v.X, p0 + u * step);
    in[u] = p0 + u * step < hi && st[u].inslab;
    if (in[u]) {
      window(v, st[u], m.blend, win[u]);
    } else {
      win[u][0][0] = win[u][0][1] = win[u][1][0] = win[u][1][1] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < kFusedRows; ++i) t[u][i] = 0.f;
    if (in[u]) t[u][kValueRow] = step_terms(r, st[u], win[u], t[u]);
  }
}

// fused_terms on a bf16 copy: U steps' windows loaded raw first
// (window_raw: 4U loads in flight, 8U in blend mode), then each widened and
// lerped (widen_window) and its terms formed in step order. The same
// float32 operations on the same values as the float32 copy's
// fused_terms, so the terms are its terms on the density rounded to bf16,
// bit for bit.
template <int U, int A>
JOSEPH_HD void fused_terms(const Ray& r, const brick::Volume<A, brick::bf16>& v, const March& m,
                           int p0, int step, int hi, float t[U][kFusedRows]) {
  Step st[U];
  bool in[U];
  brick::bf16 raw[U][2][2][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    st[u] = step_at(r, m, v.X, p0 + u * step);
    in[u] = p0 + u * step < hi && st[u].inslab;
    window_raw(v, st[u], m.blend, in[u], raw[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < kFusedRows; ++i) t[u][i] = 0.f;
    if (in[u]) {
      float win[2][2];
      widen_window(raw[u], st[u], m.blend, win);
      t[u][kValueRow] = step_terms(r, st[u], win, t[u]);
    }
  }
}

// joseph_bwd_rays' lanes a ray (G) and steps a lane keeps in flight (U) in
// sum mode, from bwd_rays_timing.py's probes (joseph.cu says why these).
constexpr int kBwdLanes = 8;
constexpr int kBwdSteps = 1;

#if defined(__CUDACC__)
// Thread t's part in a fused launch of G lanes a ray and U steps in flight
// a lane (joseph_fwdgrad, joseph_bwd_rays' sum mode, and the probes), from
// the strided density or its bricked copy: lane t % G of ray t / G, in
// passes of G * U steps (lanes.cuh). Sum mode (arg == nullptr): lane i % G
// writes row i of out (N, n_rays), the fused march's first N rows
// (fused_terms): all 8 for joseph_fwdgrad, or the 7 gradient rows each
// times g[r] once they are summed when g is given (joseph_bwd_rays:
// trace_bwd_rays' rows, bit for bit). MIP: each lane keeps the first
// maximum of its own steps, the lanes' tree combines them, lane 0 writes
// the argmax step to arg[r], and out gets the argmax step's first N rows.
// Blocks of kFusedThreads; every thread of a warp must call this (those of
// rays past the end too): the passes hand summands over through the warp's
// shared memory, and the tree shuffles. A warp holds 32 / G whole rays.
template <int G, int U, int N = kFusedRows, class Vol>
__device__ __forceinline__ void fwdgrad_lanes(const float* __restrict__ rows, int64_t n_rays,
                                              const Vol& v, const March& m,
                                              float* __restrict__ out, int* __restrict__ arg,
                                              int64_t t, const float* __restrict__ g = nullptr) {
  constexpr int kSteps = G * U;        // a ray's steps a pass
  constexpr int kStride = 32 * U + 1;  // a row of the warp's hand-over (+1: no bank conflicts)
  __shared__ float hand[kFusedThreads / 32][N * kStride];
  int64_t r = t / G;
  int lane = (int)(t % G);
  bool live = r < n_rays;
  bool mip = arg != nullptr;  // the same for the whole grid
  Ray ray{};
  int lo = 0, hi = 0;
  if (live) {
    ray = load_ray(rows, n_rays, r);
    step_range(ray, m, &lo, &hi);
  }
  int passes = lanes::warp_passes((hi - lo + kSteps - 1) / kSteps);
  float* mine = hand[threadIdx.x / 32] + (threadIdx.x % 32) / G * kSteps;  // the ray's columns
  float acc[lanes::kSlots<G, N>] = {};
  float best[kFusedRows] = {};
  int best_p = -1;
  for (int p = 0; p < passes; ++p) {
    int p0 = lo + p * kSteps + lane;
    float tm[U][kFusedRows];
    fused_terms<U>(ray, v, m, p0, G, hi, tm);
    if (mip) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (tm[u][kValueRow] > best[kValueRow]) {
#pragma unroll
          for (int i = 0; i < kFusedRows; ++i) best[i] = tm[u][i];
          best_p = p0 + u * G;
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < N; ++i) mine[i * kStride + u * G + lane] = tm[u][i];
      __syncwarp();
      lanes::take_in_order<G, N, kSteps>(mine, kStride, lane, acc);
      __syncwarp();
    }
  }
  if (mip) lanes::combine_max_warp<G, kFusedRows, kValueRow>(best, &best_p);
  if (!live) return;
  if (mip) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i % G == lane) out[i * n_rays + r] = best[i];
    if (lane == 0) arg[r] = best_p;
  } else {
    float gr = g ? g[r] : 0.f;
#pragma unroll
    for (int slot = 0; slot < lanes::kSlots<G, N>; ++slot) {
      int i = lane + slot * G;
      if (i < N) out[i * n_rays + r] = g ? acc[slot] * gr : acc[slot];
    }
  }
}
#endif

// The two-pass pose backward: acc[0..6] = g * d(value)/d(row), from the
// strided density (Volume) or, in the probes, its bricked copy
// (brick::Volume), step after step (the order of sums that fwdgrad_lanes
// keeps), then one product by g. In MIP mode only the argmax step counts
// (none when arg is -1).
template <class Vol>
JOSEPH_HD void trace_bwd_rays(const Ray& r, const Vol& v, const March& m, float g, int arg,
                              bool mip, float acc[kRows]) {
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  int lo, hi;
  if (mip) {
    if (arg < 0 || arg >= m.n_steps) return;
    lo = arg;
    hi = arg + 1;
  } else {
    step_range(r, m, &lo, &hi);
  }
  for (int p = lo; p < hi; ++p) {
    Step s = step_at(r, m, v.X, p);
    if (!s.inslab) continue;
    float win[2][2];
    window(v, s, m.blend, win);
    float terms[kRows];
    step_terms(r, s, win, terms);
    for (int i = 0; i < kRows; ++i) acc[i] += terms[i];
  }
  for (int i = 0; i < kRows; ++i) acc[i] *= g;
}

// One write of the density gradient: an atomic add on the device, where
// many rays may hit one voxel at once; a plain add in a serial host build.
JOSEPH_HD void add_grad(float* p, float x) {
#if defined(__CUDA_ARCH__)
  atomicAdd(p, x);
#else
  *p += x;
#endif
}

// The most adds one step makes to the density gradient: 4 neighbours on
// each of 2 planes.
constexpr int kStepAdds = 8;

// Slot q of a step's adds: x onto voxel (k, fy, fz), when the voxel lies in
// the volume and x is not 0. Sets bit q of *mask and off[q], xs[q].
JOSEPH_HD void add_at(const GradVolume& gv, int k, float fy, float fz, float x, int q,
                      int64_t off[kStepAdds], float xs[kStepAdds], unsigned* mask) {
  if (x == 0.f) return;
  if (!(k >= 0 && k < gv.X && fy >= 0.f && fy < (float)gv.Y && fz >= 0.f && fz < (float)gv.Z))
    return;
  off[q] = (int64_t)k * gv.ss + (int64_t)fy * gv.sy + (int64_t)fz * gv.sz;
  xs[q] = x;
  *mask |= 1u << q;
}

// One step's share of d(loss)/d(volume): (wy_m g) (wz_n scale) onto its 4
// in-plane neighbours, split (1 - fx, fx) over the plane pair in blend mode
// (8 voxels). Neighbours outside the volume (plane X included) and zero
// weights add nothing. Returns the mask of the slots that add, slot
// (m * 2 + n) * 2 + plane, and for each of them the voxel's element offset
// into gv.data in off[slot] and the value in x[slot].
JOSEPH_HD unsigned step_adds(const GradVolume& gv, const Step& s, bool blend, float g,
                             int64_t off[kStepAdds], float x[kStepAdds]) {
  unsigned mask = 0u;
  for (int mm = 0; mm < 2; ++mm) {
    float wyg = s.wy[mm] * g;
    for (int nn = 0; nn < 2; ++nn) {
      float v = wyg * (s.wz[nn] * s.scale);
      float fy = s.fy + (float)mm;
      float fz = s.fz + (float)nn;
      int q = (mm * 2 + nn) * 2;
      if (blend) {
        add_at(gv, s.k0, fy, fz, v * (1.f - s.fx), q, off, x, &mask);
        add_at(gv, s.k0 + 1, fy, fz, v * s.fx, q + 1, off, x, &mask);
      } else {
        add_at(gv, s.k0, fy, fz, v, q, off, x, &mask);
      }
    }
  }
  return mask;
}

// Makes the adds of a step_adds mask, slot by slot.
JOSEPH_HD void add_all(float* grad, unsigned mask, const int64_t off[kStepAdds],
                       const float x[kStepAdds]) {
  for (int q = 0; q < kStepAdds; ++q)
    if (mask >> q & 1u) add_grad(grad + off[q], x[q]);
}

// Step p's adds to d(loss)/d(volume) with the ray's g, as step_adds writes
// them; none outside the slab. A pure function of the ray and p, so the
// steps of one ray can be scattered in any order, by any thread.
JOSEPH_HD unsigned step_adds_at(const Ray& r, const GradVolume& gv, const March& m, int p,
                                float g, int64_t off[kStepAdds], float x[kStepAdds]) {
  Step s = step_at(r, m, gv.X, p);
  return s.inslab ? step_adds(gv, s, m.blend, g, off, x) : 0u;
}

// The steps [lo, hi) that d(loss)/d(volume) visits: the step range, or in
// MIP mode only the argmax step (none when arg is -1).
JOSEPH_HD void scatter_range(const Ray& r, const March& m, int arg, bool mip, int* lo, int* hi) {
  if (!mip) {
    step_range(r, m, lo, hi);
  } else if (arg < 0 || arg >= m.n_steps) {
    *lo = *hi = 0;
  } else {
    *lo = arg;
    *hi = arg + 1;
  }
}

// d(loss)/d(volume) of one ray, step after step (the serial order; the
// kernel spreads the same step_adds_at calls over a warp's lanes).
JOSEPH_HD void trace_bwd_vol(const Ray& r, const GradVolume& gv, const March& m, float g,
                             int arg, bool mip) {
  int lo, hi;
  scatter_range(r, m, arg, mip, &lo, &hi);
  int64_t off[kStepAdds];
  float x[kStepAdds];
  for (int p = lo; p < hi; ++p) add_all(gv.data, step_adds_at(r, gv, m, p, g, off, x), off, x);
}

// ---------------------------------------------------------------------------
// Channels
// ---------------------------------------------------------------------------

// Voxel (k, ry, rz) of the labelmap, inside its extents (label_at tests).
JOSEPH_HD int label_voxel(const Labels& l, int k, float ry, float rz) {
  return l.data[(int64_t)k * l.ss + (int64_t)ry * l.sy + (int64_t)rz * l.sz];
}

// The labelmap's bricked copy, as march axis A sees it: brick_copy of its
// int32 labels' bits seen as float32 (ops/kernels/brick.py), so it shares
// the density copy's brick strides and extents.
template <int A>
struct BrickLabels : brick::Volume<A> {};

template <int A>
JOSEPH_HD int label_voxel(const BrickLabels<A>& l, int k, float ry, float rz) {
  float bits = brick::load(l.data + brick::offset(l, k, (int)ry, (int)rz));
  int label;
  memcpy(&label, &bits, sizeof label);
  return label;
}

// The label of the step's sample at its nearest voxel, by the TPU kernel's
// rule (_onehot_at, _get_lab): the transverse position rounded half to even
// (rintf), plane k0 at an integer h and, at a fractional h, plane k0 + 1
// only when fx > 0.5 (a tie takes k0). A position outside the volume, plane
// X included, reads label 0. Lab is Labels, or any labelmap with extents
// X, Y, Z and a label_voxel of its own (BrickLabels).
template <class Lab>
JOSEPH_HD int label_at(const Lab& l, const Ray& r, const Step& s, bool blend) {
  int k = (blend && s.fx > 0.5f) ? s.k0 + 1 : s.k0;
  float ry = rintf(r.gy + s.alpha * r.dy);
  float rz = rintf(r.gz + s.alpha * r.dz);
  if (!(k >= 0 && k < l.X && ry >= 0.f && ry < (float)l.Y && rz >= 0.f && rz < (float)l.Z))
    return 0;
  return label_voxel(l, k, ry, rz);
}

// The channel a label lands in, or -1 for a label outside [0, C).
JOSEPH_HD int channel_of(int label, int n_channels) {
  return label >= 0 && label < n_channels ? label : -1;
}

// The channel forward of one ray: out[c * n_rays] (the ray's column of a
// (C, n_rays) image) = sum of sample * scale over its steps whose label is
// c. A step with scale <= 0 votes for no channel (_fwd_kernel's -1 label).
JOSEPH_HD void trace_fwd_ch(const Ray& r, const Volume& v, const Labels& l, const March& m,
                            int n_channels, float* out, int64_t n_rays) {
  for (int c = 0; c < n_channels; ++c) out[c * n_rays] = 0.f;
  int lo, hi;
  step_range(r, m, &lo, &hi);
  for (int p = lo; p < hi; ++p) {
    Step s = step_at(r, m, v.X, p);
    if (!(s.scale > 0.f)) continue;  // outside the slab, or a zero-length sample
    int c = channel_of(label_at(l, r, s, m.blend), n_channels);
    if (c < 0) continue;
    float win[2][2];
    window(v, s, m.blend, win);
    out[c * n_rays] += sample(s, win);
  }
}

// The channel forward's samples of U steps p0, p0 + step, ...,
// p0 + (U - 1) step: c[u] the step's channel and x[u] its sample * scale,
// the value trace_fwd_ch adds to that channel; c[u] = -1 (no channel) for a
// step at or past hi (step_range's end), with scale <= 0 or whose label
// drops. The labels and the windows of the U steps are read first, neither
// waiting on the other (4U loads in flight, 8U at a fractional h, and U
// labels), then the samples. A pure function of the ray and the steps, so
// any lane can take any step.
template <int U, class Vol, class Lab>
JOSEPH_HD void channel_samples(const Ray& r, const Vol& v, const Lab& l, const March& m,
                               int n_channels, int p0, int step, int hi, int c[U], float x[U]) {
  Step st[U];
  int lab[U];
  float win[U][2][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    st[u] = step_at(r, m, v.X, p0 + u * step);
    lab[u] = -1;
    if (p0 + u * step < hi && st[u].scale > 0.f) {
      lab[u] = label_at(l, r, st[u], m.blend);
      window(v, st[u], m.blend, win[u]);
    } else {
      win[u][0][0] = win[u][0][1] = win[u][1][0] = win[u][1][1] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    c[u] = channel_of(lab[u], n_channels);
    x[u] = sample(st[u], win[u]);
  }
}

// channel_samples on a bf16 copy: U steps' windows loaded raw (window_raw:
// 4U 16-bit loads in flight, 8U at a fractional h) beside their labels (the
// labelmap's copy keeps its int32 bits, read by label_at as above), then
// each window widened and lerped (widen_window) and its sample formed in
// step order. The same float32 operations on the same values as the
// float32 copy's channel_samples, so the channels and samples are its own
// on the density rounded to bf16, bit for bit.
template <int U, int A, class Lab>
JOSEPH_HD void channel_samples(const Ray& r, const brick::Volume<A, brick::bf16>& v, const Lab& l,
                               const March& m, int n_channels, int p0, int step, int hi, int c[U],
                               float x[U]) {
  Step st[U];
  int lab[U];
  brick::bf16 raw[U][2][2][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    st[u] = step_at(r, m, v.X, p0 + u * step);
    bool read = p0 + u * step < hi && st[u].scale > 0.f;
    lab[u] = read ? label_at(l, r, st[u], m.blend) : -1;
    window_raw(v, st[u], m.blend, read, raw[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float win[2][2];
    widen_window(raw[u], st[u], m.blend, win);
    c[u] = channel_of(lab[u], n_channels);
    x[u] = sample(st[u], win);
  }
}

// A ray's running sums of the channels [c0, c0 + tile), at
// sums[(c - c0) * stride] (the kernel's shared memory, or a host array),
// with the sum of the last sample's channel held in acc (slot cur) until
// the channel changes: a run of samples in one structure reads and writes
// sums once. Each sum is trace_fwd_ch's out[c] += x, from +0 and in the
// order the samples come, so given them in step order the bits are its own.
struct ChannelSums {
  float* sums;
  int stride, c0, tile;
  int cur;
  float acc;
};

JOSEPH_HD ChannelSums channel_sums(float* sums, int stride, int c0, int tile) {
  for (int c = 0; c < tile; ++c) sums[c * stride] = 0.f;
  return ChannelSums{sums, stride, c0, tile, -1, 0.f};
}

// Adds sample x to channel c (-1 or a channel outside the tile: nothing).
JOSEPH_HD void add_sample(ChannelSums& s, int c, float x) {
  c -= s.c0;  // no channel (-1) stays below 0
  if (c < 0 || c >= s.tile) return;
  if (c != s.cur) {
    if (s.cur >= 0) s.sums[s.cur * s.stride] = s.acc;
    s.acc = s.sums[c * s.stride];
    s.cur = c;
  }
  s.acc += x;
}

// Stores the running sum: sums then holds every channel's.
JOSEPH_HD void flush(ChannelSums& s) {
  if (s.cur >= 0) s.sums[s.cur * s.stride] = s.acc;
}

// joseph_fwd_ch's lanes a ray (G) and the steps a lane keeps in flight
// (U), from max_channel_timing.py's probes (joseph.cu says why these);
// kFwdChLanesOf<T> and kFwdChStepsOf<T> on a copy of element T, a bf16
// one's its own. G also sizes the kernel's launch and its block's sums.
constexpr int kFwdChLanes = 8;
constexpr int kFwdChSteps = 1;
template <class T>
constexpr int kFwdChLanesOf = kFwdChLanes;
template <>
constexpr int kFwdChLanesOf<brick::bf16> = 4;
template <class T>
constexpr int kFwdChStepsOf = kFwdChSteps;
template <>
constexpr int kFwdChStepsOf<brick::bf16> = 1;

#if defined(__CUDACC__)
// Thread t's part in joseph_fwd_ch (and the probes): lane t % G of ray
// t / G, in passes of G * U steps, lane j taking steps base + j,
// base + j + G, ... (channel_samples); the ray's lane 0 takes each pass's
// samples from its lanes by shuffles in step order and adds them to the
// ray's channel sums (ChannelSums), then writes the ray's column of out
// (C, n_rays). The sums of the channels [c0, c0 + tile) live at
// sums[(c - c0) * stride] (the block's shared memory: the ray's column of
// a [channel][ray] array), the channels in tiles, one march a tile. Every
// thread of a warp must call this (those of rays past the end too): the
// shuffles take all 32.
template <int G, int U, class Vol, class Lab>
__device__ __forceinline__ void fwd_ch_lanes(const float* __restrict__ rows, int64_t n_rays,
                                             const Vol& v, const Lab& l, const March& m,
                                             int n_channels, int tile, float* sums, int stride,
                                             float* __restrict__ out, int64_t t) {
  int64_t r = t / G;
  int lane = (int)(t % G);
  bool live = r < n_rays;
  Ray ray{};
  int lo = 0, hi = 0;
  if (live) {
    ray = load_ray(rows, n_rays, r);
    step_range(ray, m, &lo, &hi);
  }
  int passes = lanes::warp_passes((hi - lo + G * U - 1) / (G * U));
  int first = (int)(threadIdx.x % 32) / G * G;  // the ray's lane 0 in the warp
  for (int c0 = 0; c0 < n_channels; c0 += tile) {
    int width = min(tile, n_channels - c0);
    ChannelSums cs{};
    if (lane == 0) cs = channel_sums(sums, stride, c0, width);
    for (int p = 0; p < passes; ++p) {
      int c[U];
      float x[U];
      channel_samples<U>(ray, v, l, m, n_channels, lo + p * G * U + lane, G, hi, c, x);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          int cj = __shfl_sync(lanes::kFullMask, c[u], first + j);
          float xj = __shfl_sync(lanes::kFullMask, x[u], first + j);
          if (lane == 0) add_sample(cs, cj, xj);
        }
      }
    }
    if (lane == 0 && live) {
      flush(cs);
      for (int c = 0; c < width; ++c) out[(int64_t)(c0 + c) * n_rays + r] = sums[c * stride];
    }
  }
}
#endif

// The channel pose backward's summands of U steps p0, p0 + step, ...,
// p0 + (U - 1) step: t[u][i] = the step's term i times g[c * n_rays], the
// cotangent of its channel c (g is the ray's column of a (C, n_rays)
// cotangent). All exactly 0 for a step outside the slab, at or past hi
// (step_range's end), or whose label drops. The labels and the windows of
// the U steps are read first, neither waiting on the other (4U loads in
// flight, 8U at a fractional h, and U labels), then the cotangents, which
// wait on the labels, and the terms. A pure function of the ray and the
// steps, so any lane can take any step; trace_bwd_rays_ch adds them one
// step at a time, bwd_rays_ch_lanes in passes.
template <int U, class Vol, class Lab>
JOSEPH_HD void channel_terms(const Ray& r, const Vol& v, const Lab& l, const March& m,
                             int n_channels, const float* g, int64_t n_rays, int p0, int step,
                             int hi, float t[U][kRows]) {
  Step st[U];
  int lab[U];
  float win[U][2][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    st[u] = step_at(r, m, v.X, p0 + u * step);
    lab[u] = -1;  // no channel
    if (p0 + u * step < hi && st[u].inslab) {
      lab[u] = label_at(l, r, st[u], m.blend);
      window(v, st[u], m.blend, win[u]);
    } else {
      win[u][0][0] = win[u][0][1] = win[u][1][0] = win[u][1][1] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) t[u][i] = 0.f;
    int c = channel_of(lab[u], n_channels);
    if (c < 0) continue;
    float gc = g[c * n_rays];
    float terms[kRows];
    step_terms(r, st[u], win[u], terms);
#pragma unroll
    for (int i = 0; i < kRows; ++i) t[u][i] = terms[i] * gc;
  }
}

// channel_terms on a bf16 copy: U steps' windows loaded raw (window_raw:
// 4U 16-bit loads in flight, 8U at a fractional h) beside their labels,
// then the U cotangents their labels pick, then each window widened and
// lerped (widen_window) and its terms formed in step order. The same
// float32 operations on the same values as the float32 copy's
// channel_terms, so the summands are its own on the density rounded to
// bf16, bit for bit.
template <int U, int A, class Lab>
JOSEPH_HD void channel_terms(const Ray& r, const brick::Volume<A, brick::bf16>& v, const Lab& l,
                             const March& m, int n_channels, const float* g, int64_t n_rays,
                             int p0, int step, int hi, float t[U][kRows]) {
  Step st[U];
  int lab[U];
  brick::bf16 raw[U][2][2][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    st[u] = step_at(r, m, v.X, p0 + u * step);
    bool read = p0 + u * step < hi && st[u].inslab;
    lab[u] = read ? label_at(l, r, st[u], m.blend) : -1;  // -1: no channel
    window_raw(v, st[u], m.blend, read, raw[u]);
  }
  int c[U];
  float gc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    c[u] = channel_of(lab[u], n_channels);
    gc[u] = c[u] < 0 ? 0.f : g[c[u] * n_rays];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) t[u][i] = 0.f;
    if (c[u] < 0) continue;
    float win[2][2];
    widen_window(raw[u], st[u], m.blend, win);
    float terms[kRows];
    step_terms(r, st[u], win, terms);
#pragma unroll
    for (int i = 0; i < kRows; ++i) t[u][i] = terms[i] * gc[u];
  }
}

// The channel pose backward: acc[0..6] = sum over steps of the step's 7
// terms times the cotangent of its channel, step after step (the order of
// sums that bwd_rays_ch_lanes keeps). No final product by g. A step that
// adds nothing adds +0, which leaves every sum as it was: a sum that starts
// at +0 is never -0.
JOSEPH_HD void trace_bwd_rays_ch(const Ray& r, const Volume& v, const Labels& l,
                                 const March& m, int n_channels, const float* g,
                                 int64_t n_rays, float acc[kRows]) {
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  int lo, hi;
  step_range(r, m, &lo, &hi);
  for (int p = lo; p < hi; ++p) {
    float t[1][kRows];
    channel_terms<1>(r, v, l, m, n_channels, g, n_rays, p, 1, hi, t);
    for (int i = 0; i < kRows; ++i) acc[i] += t[0][i];
  }
}

// joseph_bwd_rays_ch's lanes a ray (G), the steps a lane keeps in flight
// (U), from channel_timing.py's probes (joseph.cu says why these);
// kChannelLanesOf<T> and kChannelStepsOf<T> on a copy of element T, a bf16
// one's its own.
constexpr int kChannelLanes = 16;
constexpr int kChannelSteps = 1;
template <class T>
constexpr int kChannelLanesOf = kChannelLanes;
template <>
constexpr int kChannelLanesOf<brick::bf16> = 8;
template <class T>
constexpr int kChannelStepsOf = kChannelSteps;
template <>
constexpr int kChannelStepsOf<brick::bf16> = 1;

#if defined(__CUDACC__)
// Thread t's part in joseph_bwd_rays_ch (and the probes): lane t % G of ray
// t / G, in passes of G * U steps as fwdgrad_lanes' sum mode: lane j
// computes steps base + j, base + j + G, ... (channel_terms), the lanes
// hand the summands over through the warp's shared memory, and lane i % G
// adds row i in step order (lanes::take_in_order), so the rows are
// trace_bwd_rays_ch's bit for bit; lane i % G writes row i of out
// (7, n_rays). g: the (C, n_rays) cotangent. Blocks of kFusedThreads; every
// thread of a warp must call this (those of rays past the end too), since
// each pass's hand-over ends in a __syncwarp.
template <int G, int U, class Vol, class Lab>
__device__ __forceinline__ void bwd_rays_ch_lanes(const float* __restrict__ rows,
                                                  int64_t n_rays, const Vol& v, const Lab& l,
                                                  const March& m, int n_channels,
                                                  const float* __restrict__ g,
                                                  float* __restrict__ out, int64_t t) {
  constexpr int kSteps = G * U;        // a ray's steps a pass
  constexpr int kStride = 32 * U + 1;  // a row of the warp's hand-over (+1: no bank conflicts)
  __shared__ float hand[kFusedThreads / 32][kRows * kStride];
  int64_t r = t / G;
  int lane = (int)(t % G);
  bool live = r < n_rays;
  Ray ray{};
  int lo = 0, hi = 0;
  if (live) {
    ray = load_ray(rows, n_rays, r);
    step_range(ray, m, &lo, &hi);
  }
  const float* gr = g + (live ? r : 0);  // the ray's cotangent column
  int passes = lanes::warp_passes((hi - lo + kSteps - 1) / kSteps);
  float* mine = hand[threadIdx.x / 32] + (threadIdx.x % 32) / G * kSteps;  // the ray's columns
  float acc[lanes::kSlots<G, kRows>] = {};
  for (int p = 0; p < passes; ++p) {
    float tm[U][kRows];
    channel_terms<U>(ray, v, l, m, n_channels, gr, n_rays, lo + p * kSteps + lane, G, hi, tm);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < kRows; ++i) mine[i * kStride + u * G + lane] = tm[u][i];
    __syncwarp();
    lanes::take_in_order<G, kRows, kSteps>(mine, kStride, lane, acc);
    __syncwarp();
  }
  if (!live) return;
#pragma unroll
  for (int slot = 0; slot < lanes::kSlots<G, kRows>; ++slot) {
    int i = lane + slot * G;
    if (i < kRows) out[i * n_rays + r] = acc[slot];
  }
}
#endif

// Step p's adds to d(loss)/d(volume), as step_adds writes them, with the
// cotangent of its channel, g[c * n_rays] (g the ray's column of a
// (C, n_rays) cotangent); none for a step outside the slab or whose label
// drops. A pure function of the ray and p, as step_adds_at is: the channel
// scatter's warp spreads the steps of one ray over its lanes.
JOSEPH_HD unsigned step_adds_ch_at(const Ray& r, const GradVolume& gv, const Labels& l,
                                   const March& m, int p, int n_channels, const float* g,
                                   int64_t n_rays, int64_t off[kStepAdds],
                                   float x[kStepAdds]) {
  Step s = step_at(r, m, gv.X, p);
  if (!s.inslab) return 0u;
  int c = channel_of(label_at(l, r, s, m.blend), n_channels);
  return c < 0 ? 0u : step_adds(gv, s, m.blend, g[c * n_rays], off, x);
}

// The channel density backward of one ray, step after step (the serial
// order; joseph_bwd_vol_ch spreads the same step_adds_ch_at calls over a
// warp's lanes).
JOSEPH_HD void trace_bwd_vol_ch(const Ray& r, const GradVolume& gv, const Labels& l,
                                const March& m, int n_channels, const float* g,
                                int64_t n_rays) {
  int lo, hi;
  step_range(r, m, &lo, &hi);
  int64_t off[kStepAdds];
  float x[kStepAdds];
  for (int p = lo; p < hi; ++p)
    add_all(gv.data, step_adds_ch_at(r, gv, l, m, p, n_channels, g, n_rays, off, x), off, x);
}

}  // namespace joseph
