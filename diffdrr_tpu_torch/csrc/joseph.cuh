// Joseph plane march and trilinear ray march: the per-ray, per-step arithmetic.
//
// Shared by the CUDA kernels in joseph.cu and by any host build (the
// JOSEPH_HD macro is empty without nvcc), so the kernels' own arithmetic can
// be compiled and checked on a machine without a GPU.
//
// Geometry (the rows are packed by diffdrr_tpu_torch/ops/kernels/prep.py with
// the Joseph quadrature): the volume is read through its strides in (s, y, z)
// order, s being the march axis, or (trace_fwd, fused_terms) through its
// bricked copy in the same order (brick.cuh). Step p samples the ray at
// axis position k = p * h, where alpha = k * a + b and the transverse
// position is (gy + alpha dy, gz + alpha dz). The sample counts only
// inside the ray's [amin, amax] (clamped to [0, 1]) and is weighted by
// sc = w |1/d_s| h.
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
// gradient is gated to that step.
//
// Channels (mask_to_channels): each step also reads the labelmap at the
// sample's nearest voxel (label_at) and lands in that label's channel; a
// label outside [0, C) adds nothing. The forward adds the step's value to
// its channel, and both backwards take the cotangent of that channel for
// the step. Channel renders are always sums.
#pragma once

#include <math.h>
#include <stdint.h>

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
template <int A>
JOSEPH_HD float voxel(const brick::Volume<A>& v, int k, float fy, float fz) {
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

// The loads joseph_fwd keeps in flight: the windows of this many steps.
constexpr int kFwdSteps = 4;

// sum over steps of sample * scale, from the strided density (Volume) or
// its bricked copy (brick::Volume). U steps at a time: their windows first,
// so up to 4U (8U in blend mode) loads are in flight, then their samples in
// step order, so the value is bit for bit the U = 1 one.
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
      if (in[u]) acc += bilinear(st[u], win[u]) * st[u].scale;
  }
  return acc;
}

// MIP: the largest sample * scale and its step. A strict > keeps the first
// maximum; the running max starts at 0 and the step at -1.
JOSEPH_HD void trace_fwd_max(const Ray& r, const Volume& v, const March& m, float* val,
                             int* arg) {
  int lo, hi;
  step_range(r, m, &lo, &hi);
  float best = 0.f;
  int best_p = -1;
  for (int p = lo; p < hi; ++p) {
    Step s = step_at(r, m, v.X, p);
    if (!s.inslab) continue;
    float win[2][2];
    window(v, s, m.blend, win);
    float x = bilinear(s, win) * s.scale;
    if (x > best) {
      best = x;
      best_p = p;
    }
  }
  *val = best;
  *arg = best_p;
}

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
// and its threads a block (joseph.cu says why these).
constexpr int kFusedLanes = 8;
constexpr int kFusedSteps = 1;
constexpr int kFusedThreads = 128;

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

#if defined(__CUDACC__)
// Thread t's part in a fused launch of G lanes a ray and U steps in flight
// a lane (joseph_fwdgrad, and the probes), from the strided density or its
// bricked copy: lane t % G of ray t / G, in passes of G * U steps
// (lanes.cuh). Sum mode (arg == nullptr): lane i % G writes row i of out
// (8, n_rays). MIP: each lane keeps the first maximum of its own steps, the
// lanes' tree combines them, and lane 0 writes the argmax step to arg[r].
// Blocks of kFusedThreads; every thread of a warp must call this (those of
// rays past the end too): the passes hand summands over through the warp's
// shared memory, and the tree shuffles. A warp holds 32 / G whole rays.
template <int G, int U, class Vol>
__device__ __forceinline__ void fwdgrad_lanes(const float* __restrict__ rows, int64_t n_rays,
                                              const Vol& v, const March& m,
                                              float* __restrict__ out, int* __restrict__ arg,
                                              int64_t t) {
  constexpr int kSteps = G * U;        // a ray's steps a pass
  constexpr int kStride = 32 * U + 1;  // a row of the warp's hand-over (+1: no bank conflicts)
  __shared__ float hand[kFusedThreads / 32][kFusedRows * kStride];
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
  float acc[lanes::kSlots<G, kFusedRows>] = {};
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
        for (int i = 0; i < kFusedRows; ++i) mine[i * kStride + u * G + lane] = tm[u][i];
      __syncwarp();
      lanes::take_in_order<G, kFusedRows, kSteps>(mine, kStride, lane, acc);
      __syncwarp();
    }
  }
  if (mip) lanes::combine_max_warp<G, kFusedRows, kValueRow>(best, &best_p);
  if (!live) return;
  if (mip) {
#pragma unroll
    for (int i = 0; i < kFusedRows; ++i)
      if (i % G == lane) out[i * n_rays + r] = best[i];
    if (lane == 0) arg[r] = best_p;
  } else {
#pragma unroll
    for (int slot = 0; slot < lanes::kSlots<G, kFusedRows>; ++slot) {
      int i = lane + slot * G;
      if (i < kFusedRows) out[i * n_rays + r] = acc[slot];
    }
  }
}
#endif

// The two-pass pose backward: acc[0..6] = g * d(value)/d(row). In MIP mode
// only the argmax step counts (none when arg is -1).
JOSEPH_HD void trace_bwd_rays(const Ray& r, const Volume& v, const March& m, float g, int arg,
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

// One step's adds, made at once.
JOSEPH_HD void scatter_step(const GradVolume& gv, const Step& s, bool blend, float g) {
  int64_t off[kStepAdds];
  float x[kStepAdds];
  add_all(gv.data, step_adds(gv, s, blend, g, off, x), off, x);
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

// The label of the step's sample at its nearest voxel, by the TPU kernel's
// rule (_onehot_at, _get_lab): the transverse position rounded half to even
// (rintf), plane k0 at an integer h and, at a fractional h, plane k0 + 1
// only when fx > 0.5 (a tie takes k0). A position outside the volume, plane
// X included, reads label 0.
JOSEPH_HD int label_at(const Labels& l, const Ray& r, const Step& s, bool blend) {
  int k = (blend && s.fx > 0.5f) ? s.k0 + 1 : s.k0;
  float ry = rintf(r.gy + s.alpha * r.dy);
  float rz = rintf(r.gz + s.alpha * r.dz);
  if (!(k >= 0 && k < l.X && ry >= 0.f && ry < (float)l.Y && rz >= 0.f && rz < (float)l.Z))
    return 0;
  return l.data[(int64_t)k * l.ss + (int64_t)ry * l.sy + (int64_t)rz * l.sz];
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
    out[c * n_rays] += bilinear(s, win) * s.scale;
  }
}

// The channel pose backward: acc[0..6] = sum over steps of the step's 7
// terms times g[c * n_rays], the cotangent of the step's channel c (g is
// the ray's column of a (C, n_rays) cotangent). No final product by g.
JOSEPH_HD void trace_bwd_rays_ch(const Ray& r, const Volume& v, const Labels& l,
                                 const March& m, int n_channels, const float* g,
                                 int64_t n_rays, float acc[kRows]) {
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  int lo, hi;
  step_range(r, m, &lo, &hi);
  for (int p = lo; p < hi; ++p) {
    Step s = step_at(r, m, v.X, p);
    if (!s.inslab) continue;
    int c = channel_of(label_at(l, r, s, m.blend), n_channels);
    if (c < 0) continue;
    float gc = g[c * n_rays];
    float win[2][2];
    window(v, s, m.blend, win);
    float terms[kRows];
    step_terms(r, s, win, terms);
    for (int i = 0; i < kRows; ++i) acc[i] += terms[i] * gc;
  }
}

// The channel density backward: every in-slab step scatters with the
// cotangent of its channel.
JOSEPH_HD void trace_bwd_vol_ch(const Ray& r, const GradVolume& gv, const Labels& l,
                                const March& m, int n_channels, const float* g,
                                int64_t n_rays) {
  int lo, hi;
  step_range(r, m, &lo, &hi);
  for (int p = lo; p < hi; ++p) {
    Step s = step_at(r, m, gv.X, p);
    if (!s.inslab) continue;
    int c = channel_of(label_at(l, r, s, m.blend), n_channels);
    if (c < 0) continue;
    scatter_step(gv, s, m.blend, g[c * n_rays]);
  }
}

}  // namespace joseph
