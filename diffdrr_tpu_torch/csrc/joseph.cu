// CUDA kernels for the Joseph plane march and the trilinear ray march (sm_90a).
//
// They replace the TPU kernels of diffdrr_tpu/ops/pallas/joseph.py, which
// also carry the trilinear renderer (ops/pallas/raymarch.py maps n_points to
// a fractional stride h):
//   joseph_fwd      _fwd_kernel, sum mode, and _fwd_plane_major_kernel (the
//                   same function, streamed plane by plane on the TPU);
//   joseph_fwd_max  _fwd_kernel, max mode: the MIP value and its argmax step;
//   joseph_fwdgrad  _fwdgrad_kernel: one march that emits the value and the 7
//                   cotangent-free gradient rows (under max: those of the
//                   argmax step), so the pose backward is rows * g;
//   joseph_bwd_rays _bwd_rays_kernel: the two-pass pose backward, sum or MIP;
//   joseph_bwd_vol  _bwd_vol_kernel: the density gradient, sum or MIP;
// and the channel mode (mask_to_channels) of three of them, which reads
// the labelmap at each sample's nearest voxel (label_at in joseph.cuh):
//   joseph_fwd_ch      _fwd_kernel with n_ch: a (C, R) image, each sample
//                      added to the channel of its label;
//   joseph_bwd_rays_ch _bwd_rays_kernel with n_ch: each step's 7 terms times
//                      the cotangent of its channel;
//   joseph_bwd_vol_ch  _bwd_vol_kernel with n_ch: each step scattered with
//                      the cotangent of its channel.
// Each takes integer and fractional h.
//
// Design: one thread per ray (the fused march and the scatter aside,
// below), walking only its own in-slab steps (step_range in joseph.cuh) and
// reading the 4 in-plane neighbours of each sample (8 at fractional h)
// straight from the float32 density through its strides (the forward and
// the fused march: its bricked copy). The TPU needed tile windows, a starts
// table, a lane roll and tent-weight matmuls on the MXU to avoid gathers;
// on the H100 a gather is a load, so none of that is carried over, and with
// no window there is no footprint to overflow.
//
// What bounds them: per ray and in-slab step, 4 (or 8) 4-byte gathers at
// data-dependent addresses and about 35 float operations for a value, about
// 90 for the gradient rows. The bytes a render must move are the voxels its
// rays touch (at most the volume: 139 MB for the 512x512x133 CT) plus 36
// bytes of rows in and 4 to 32 bytes out per ray, tens of microseconds at
// 3.35 TB/s. The simple design is bound instead by the latency of dependent
// gathers: a warp's 32 rays are neighbouring detector pixels that read
// neighbouring voxels of the same plane at the same step, so L1/L2 serve
// most reads, but a 200x200 detector gives only 40,000 threads.
// Shared-memory staging of plane windows is later work (PERF.md).
//
// joseph_fwd reads the density's bricked copy instead (brick.cuh, made by
// brick.cu once per version of the density). What bounded it on the
// strided density: in the recon-CLI cell the march axis is the density's
// unit-stride axis, so the 4 neighbour loads of a warp's 32 rays at one
// step touched ~32 cache lines each; its loads alone took 1.12 ms of its
// 1.07 at the CLI's 320,000 rays (fwd_timing.py's probes, PERF.md). On
// 4x4x4 bricks (two lines each) those loads share a few lines (loads alone
// 0.48 ms), and each thread keeps kFwdSteps = 4 steps' windows in flight
// before adding them in step order, so the value is bit for bit the
// strided serial one. The brick shape is a compile-time constant
// (brick.cuh), so a voxel's address costs constant shifts and masks and
// one multiply a brick stride. What bounds it now: the loads still, at ~2x
// the march without them (0.20 ms of the kernel's 0.43-0.46). At 1000x1000
// on the 512^3 CT, rays ~0.4 voxel apart, it is within ~2% of the strided
// kernel (PERF.md).
//
// joseph_fwdgrad, the trilinear registration step's kernel, also reads the
// bricked copy, and splits each ray over G = kFusedLanes lanes
// (joseph.cuh). One thread per ray on the strided density it was bound by
// latency and occupancy, as siddon_fwdgrad was (siddon.cu): 40,000 threads
// at the main cell, each a serial chain of ~133 steps of ~80 float
// operations ahead of 4 dependent loads, 8 accumulators live (0.184 ms
// against a 0.025 ms byte bound, PERF.md). The ray's march goes in passes
// of G steps, lane j taking step base + j, and the ray's rows take each
// pass's summands in step order (lanes.cuh), the serial march's sums bit
// for bit. In MIP mode each lane keeps its own first maximum and a tree of
// shuffles takes the larger value, of two equal ones the smaller step: the
// serial first maximum, argmax and rows exact. G = 8 and U = 1
// (kFusedSteps) from fwdgrad_timing.py's probes, as for Siddon; it now
// sits between its march without loads (0.067 ms at 200x200) and its
// loads alone (0.089), 0.081 ms (PERF.md).
//
// The scatter (joseph_bwd_vol) is laid out otherwise: one warp per ray. It
// adds 4 (or 8) products per in-slab step into the zero-filled gradient
// with float atomics. The bytes it must move are the gradient written once.
// What bounds it instead is the L2's atomic requests, one per 32-byte
// sector a warp instruction touches. With one thread per ray, the 32 lanes
// of an instruction are 32 rays at one plane, in 32 sectors. Here lane l
// takes step lo + l of one ray (then lo + l + 32, ...), and the warp lays
// a pass's adds out in shared memory in path order (step, then neighbour)
// and issues them 32 at a time. With the march axis the gradient's
// unit-stride axis, the adds of one neighbour column at consecutive steps
// share a sector: 39 million requests for the recon-CLI's 87 million adds,
// against 87 million one thread per ray (PERF.md). A ray whose g is 0
// returns at once. The order of the atomics changes from run to run, so
// the gradient's last bits do too. The channel scatter keeps one thread per
// ray.
//
// The channel kernels add one 4-byte label gather per step (a 7-label CT
// fits in int8, but int32 keeps the read simple) and read or write 4 * C
// bytes per ray instead of 4. The forward accumulates straight into its
// ray's column of the output: the thread owns the ray, so no atomics; the
// channel scatter is the scalar scatter with a per-step cotangent.
#include <cuda_runtime.h>

#include "joseph.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kThreads == joseph::kFusedThreads,
              "the fused kernel's hand-over is sized for its blocks");

// One thread per ray, reading the bricked copy with kFwdSteps steps' loads
// in flight (the note at the top of this file says why); A: the march axis.
template <int A>
__global__ void __launch_bounds__(kThreads)
joseph_fwd_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A> vol,
                  joseph::March m, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  out[r] = joseph::trace_fwd<joseph::kFwdSteps>(joseph::load_ray(rows, n_rays, r), vol, m);
}

__global__ void __launch_bounds__(kThreads)
joseph_fwd_max_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::Volume vol,
                      joseph::March m, float* __restrict__ out, int* __restrict__ arg) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  joseph::trace_fwd_max(joseph::load_ray(rows, n_rays, r), vol, m, out + r, arg + r);
}

// G = kFusedLanes lanes a ray on the bricked copy, in passes of G steps
// whose summands the ray's rows take in step order (lanes.cuh; the note at
// the top of this file says why); A: the march axis. arg == nullptr: sum
// mode; else MIP, the argmax step written to arg[r].
template <int A>
__global__ void __launch_bounds__(kThreads)
joseph_fwdgrad_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A> vol,
                      joseph::March m, float* __restrict__ out, int* __restrict__ arg) {
  joseph::fwdgrad_lanes<joseph::kFusedLanes, joseph::kFusedSteps>(
      rows, n_rays, vol, m, out, arg, (int64_t)blockIdx.x * kThreads + threadIdx.x);
}

// arg == nullptr: sum mode; else MIP, gated to the step arg[r].
__global__ void __launch_bounds__(kThreads)
joseph_bwd_rays_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::Volume vol,
                       joseph::March m, const float* __restrict__ g,
                       const int* __restrict__ arg, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  float acc[joseph::kRows];
  joseph::trace_bwd_rays(joseph::load_ray(rows, n_rays, r), vol, m, g[r], arg ? arg[r] : -1,
                         arg != nullptr, acc);
#pragma unroll
  for (int i = 0; i < joseph::kRows; ++i) out[i * n_rays + r] = acc[i];
}

// A pass's adds in path order, the lanes' in lane order and each lane's by
// slot: where this lane's first add goes, given its mask of slots that add,
// and (in *total) how many the warp has. One ballot per slot.
template <int kSlots>
__device__ __forceinline__ int warp_offset(unsigned mask, int lane, int* total) {
  unsigned below = (1u << lane) - 1u;
  int at = 0, all = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    unsigned b = __ballot_sync(kFullMask, mask >> j & 1u);
    at += __popc(b & below);
    all += __popc(b);
  }
  *total = all;
  return at;
}

// One warp per ray. Each pass takes 32 neighbouring steps of the ray, step
// lo + l (then lo + l + 32, ...) on lane l, whose adds step_adds_at
// computes; the warp lays the pass's adds out in shared memory in path
// order (step, then neighbour) and issues them 32 at a time, so each atomic
// instruction covers 32 consecutive adds along the ray. In MIP mode the ray
// has at most one step.
__global__ void __launch_bounds__(kThreads)
joseph_bwd_vol_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::March m,
                      const float* __restrict__ g, const int* __restrict__ arg,
                      joseph::GradVolume grad) {
  __shared__ int64_t s_off[kWarpsPerBlock][joseph::kStepAdds * kWarp];
  __shared__ float s_x[kWarpsPerBlock][joseph::kStepAdds * kWarp];
  int64_t r = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kWarp;
  int lane = threadIdx.x % kWarp;
  int w = threadIdx.x / kWarp;
  if (r >= n_rays) return;  // the whole warp: r is the warp's
  joseph::Ray ray = joseph::load_ray(rows, n_rays, r);
  float gr = g[r];
  if (gr == 0.f) return;  // every add is a product by g: none to make
  int lo, hi;
  joseph::scatter_range(ray, m, arg ? arg[r] : -1, arg != nullptr, &lo, &hi);
  for (int base = lo; base < hi; base += kWarp) {
    int64_t off[joseph::kStepAdds];
    float x[joseph::kStepAdds];
    int p = base + lane;
    unsigned mask = p < hi ? joseph::step_adds_at(ray, grad, m, p, gr, off, x) : 0u;
    int total;
    int at = warp_offset<joseph::kStepAdds>(mask, lane, &total);
#pragma unroll
    for (int q = 0; q < joseph::kStepAdds; ++q) {
      if (mask >> q & 1u) {
        int k = at + __popc(mask & ((1u << q) - 1u));
        s_off[w][k] = off[q];
        s_x[w][k] = x[q];
      }
    }
    __syncwarp();
    for (int k = lane; k < total; k += kWarp) atomicAdd(grad.data + s_off[w][k], s_x[w][k]);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
joseph_fwd_ch_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::Volume vol,
                     joseph::Labels lab, joseph::March m, int n_channels,
                     float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  joseph::trace_fwd_ch(joseph::load_ray(rows, n_rays, r), vol, lab, m, n_channels, out + r,
                       n_rays);
}

__global__ void __launch_bounds__(kThreads)
joseph_bwd_rays_ch_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::Volume vol,
                          joseph::Labels lab, joseph::March m, int n_channels,
                          const float* __restrict__ g, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  float acc[joseph::kRows];
  joseph::trace_bwd_rays_ch(joseph::load_ray(rows, n_rays, r), vol, lab, m, n_channels, g + r,
                            n_rays, acc);
#pragma unroll
  for (int i = 0; i < joseph::kRows; ++i) out[i * n_rays + r] = acc[i];
}

__global__ void __launch_bounds__(kThreads)
joseph_bwd_vol_ch_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::Labels lab,
                         joseph::March m, int n_channels, const float* __restrict__ g,
                         joseph::GradVolume grad) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  joseph::trace_bwd_vol_ch(joseph::load_ray(rows, n_rays, r), grad, lab, m, n_channels, g + r,
                           n_rays);
}

joseph::Labels make_labels(const int* labels, int64_t ls, int64_t ly, int64_t lz, int X, int Y,
                           int Z) {
  joseph::Labels l;
  l.data = labels;
  l.ss = ls;
  l.sy = ly;
  l.sz = lz;
  l.X = X;
  l.Y = Y;
  l.Z = Z;
  return l;
}

joseph::Volume make_volume(const float* vol, int64_t ss, int64_t sy, int64_t sz, int X, int Y,
                           int Z) {
  joseph::Volume v;
  v.data = vol;
  v.ss = ss;
  v.sy = sy;
  v.sz = sz;
  v.X = X;
  v.Y = Y;
  v.Z = Z;
  return v;
}

joseph::March make_march(float h, int n_steps, int blend) {
  joseph::March m;
  m.h = h;
  m.n_steps = n_steps;
  m.blend = blend != 0;
  return m;
}

// Blocks of kThreads for n_threads threads.
unsigned int n_blocks(int64_t n_threads) {
  return (unsigned int)((n_threads + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C interface (loaded with ctypes). rows: (9, n_rays) float32; vol: the
// density with element strides (ss, sy, sz) of the march-permuted axes and
// extents (X, Y, Z); the march: n_steps samples at k = p * h, blend != 0 for
// a fractional h (h is the float32 rounding of the caller's stride); out:
// (n_rays,) for joseph_fwd, (n_rays,) values and (n_rays,) int32 steps for
// joseph_fwd_max, (8, n_rays) for joseph_fwdgrad, (7, n_rays) for
// joseph_bwd_rays; g: (n_rays,) float32; arg: (n_rays,) int32 argmax steps
// for MIP, or NULL for sum mode (joseph_fwdgrad writes it); grad: a
// zero-filled float32 volume with the density's extents and its own strides
// (gs, gy, gz) in the same permuted order. Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
// joseph_fwd and joseph_fwdgrad read the density's bricked copy (brick.cuh)
// instead: vol is the copy, axis the march axis, then the brick strides and
// the density's extents of the march-permuted (s, y, z) axes. They return
// -1 for an axis outside 0..2.
extern "C" int joseph_fwd(const float* rows, int64_t n_rays, const float* vol, int axis,
                          int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float h,
                          int n_steps, int blend, float* out, void* stream) {
  return brick::with_axis(axis, [&](auto a) {
    constexpr int A = decltype(a)::value;
    if (n_rays > 0) {
      joseph_fwd_kernel<A><<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
          rows, n_rays, brick::make_volume<A>(vol, bs_s, bs_y, bs_z, X, Y, Z),
          make_march(h, n_steps, blend), out);
    }
    return (int)cudaGetLastError();
  });
}

extern "C" int joseph_fwd_max(const float* rows, int64_t n_rays, const float* vol, int64_t ss,
                              int64_t sy, int64_t sz, int X, int Y, int Z, float h,
                              int n_steps, int blend, float* out, int* arg, void* stream) {
  if (n_rays > 0) {
    joseph_fwd_max_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z), make_march(h, n_steps, blend),
        out, arg);
  }
  return (int)cudaGetLastError();
}

extern "C" int joseph_fwdgrad(const float* rows, int64_t n_rays, const float* vol, int axis,
                              int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float h,
                              int n_steps, int blend, float* out, int* arg, void* stream) {
  return brick::with_axis(axis, [&](auto a) {
    constexpr int A = decltype(a)::value;
    if (n_rays > 0) {
      joseph_fwdgrad_kernel<A>
          <<<n_blocks(n_rays * joseph::kFusedLanes), kThreads, 0, (cudaStream_t)stream>>>(
              rows, n_rays, brick::make_volume<A>(vol, bs_s, bs_y, bs_z, X, Y, Z),
              make_march(h, n_steps, blend), out, arg);
    }
    return (int)cudaGetLastError();
  });
}

extern "C" int joseph_bwd_rays(const float* rows, int64_t n_rays, const float* vol, int64_t ss,
                               int64_t sy, int64_t sz, int X, int Y, int Z, float h,
                               int n_steps, int blend, const float* g, const int* arg,
                               float* out, void* stream) {
  if (n_rays > 0) {
    joseph_bwd_rays_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z), make_march(h, n_steps, blend), g,
        arg, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int joseph_bwd_vol(const float* rows, int64_t n_rays, const float* g, const int* arg,
                              float* grad, int64_t gs, int64_t gy, int64_t gz, int X, int Y,
                              int Z, float h, int n_steps, int blend, void* stream) {
  if (n_rays > 0) {
    joseph::GradVolume gv;
    gv.data = grad;
    gv.ss = gs;
    gv.sy = gy;
    gv.sz = gz;
    gv.X = X;
    gv.Y = Y;
    gv.Z = Z;
    joseph_bwd_vol_kernel<<<n_blocks(n_rays * kWarp), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_march(h, n_steps, blend), g, arg, gv);
  }
  return (int)cudaGetLastError();
}

// Channel mode. labels: the int32 labelmap with element strides (ls, ly, lz)
// in the same permuted order and the density's extents; n_channels: C;
// out: (C, n_rays) for joseph_fwd_ch (every entry written), (7, n_rays) for
// joseph_bwd_rays_ch; g: (C, n_rays) float32.
extern "C" int joseph_fwd_ch(const float* rows, int64_t n_rays, const float* vol, int64_t ss,
                             int64_t sy, int64_t sz, int X, int Y, int Z, const int* labels,
                             int64_t ls, int64_t ly, int64_t lz, float h, int n_steps, int blend,
                             int n_channels, float* out, void* stream) {
  if (n_rays > 0) {
    joseph_fwd_ch_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z),
        make_labels(labels, ls, ly, lz, X, Y, Z), make_march(h, n_steps, blend), n_channels,
        out);
  }
  return (int)cudaGetLastError();
}

extern "C" int joseph_bwd_rays_ch(const float* rows, int64_t n_rays, const float* vol,
                                  int64_t ss, int64_t sy, int64_t sz, int X, int Y, int Z,
                                  const int* labels, int64_t ls, int64_t ly, int64_t lz, float h,
                                  int n_steps, int blend, int n_channels, const float* g,
                                  float* out, void* stream) {
  if (n_rays > 0) {
    joseph_bwd_rays_ch_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z),
        make_labels(labels, ls, ly, lz, X, Y, Z), make_march(h, n_steps, blend), n_channels, g,
        out);
  }
  return (int)cudaGetLastError();
}

extern "C" int joseph_bwd_vol_ch(const float* rows, int64_t n_rays, const float* g,
                                 const int* labels, int64_t ls, int64_t ly, int64_t lz,
                                 float* grad, int64_t gs, int64_t gy, int64_t gz, int X, int Y,
                                 int Z, float h, int n_steps, int blend, int n_channels,
                                 void* stream) {
  if (n_rays > 0) {
    joseph::GradVolume gv;
    gv.data = grad;
    gv.ss = gs;
    gv.sy = gy;
    gv.sz = gz;
    gv.X = X;
    gv.Y = Y;
    gv.Z = Z;
    joseph_bwd_vol_ch_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_labels(labels, ls, ly, lz, X, Y, Z), make_march(h, n_steps, blend),
        n_channels, g, gv);
  }
  return (int)cudaGetLastError();
}
