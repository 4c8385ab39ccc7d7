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
// Design: one thread per ray (joseph_fwd and the MIP pose backward; the
// MIP forward, the fused march, the two-pass pose backward's sum mode, the
// channel forward and ray backward run G lanes a ray and the scatters a
// warp, below), walking only its own in-slab steps (step_range in
// joseph.cuh) and reading the 4 in-plane neighbours of each sample (8 at
// fractional h) straight from the float32 density through its strides (the
// MIP pose backward) or from its bricked copy (the others that read it).
// The TPU needed tile windows, a starts table, a lane roll and tent-weight
// matmuls on the MXU to avoid gathers; on the H100 a gather is a load, so
// none of that is carried over, and with no window there is no footprint
// to overflow.
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
// 0.48 ms), and each thread reads kFwdSteps = 4 steps' windows before
// adding them in step order, so the value is bit for bit the strided
// serial one. The brick shape is a compile-time constant (brick.cuh), so
// a voxel's address costs constant shifts and masks and one multiply a
// brick stride. What bounds it now: the loads still, at ~2x the march
// without them (0.20 ms of the kernel's 0.43-0.46). At 1000x1000 on the
// 512^3 CT, rays ~0.4 voxel apart, it is within ~2% of the strided kernel
// (PERF.md).
//
// In blend mode (a fractional h: the trilinear march, h = 511/499 on 512
// planes) window() lerps each plane pair as its loads land, so a thread
// waited on each pair in turn (1 load in flight, cuobjdump -sass). There
// the float32 kernel runs its Blend instantiation (fwd() below): each of
// kFwdBlendSteps = 2 steps loads its window raw (trace_fwd_raw: window_raw,
// 8 loads a step, the second plane's by the same predicates), and only
// then are they lerped (widen_window, window()'s float32 operations in its
// order) and summed in step order: 16 loads in flight, and the strided
// serial march's bits. fwd_timing.py's order probes (H100, one call):
// at render-b8's geometry (8 poses at 512^2 on the 512^3 CT, 2.1 M
// threads) 11.95 ms against window()'s 14.63 at U = 4 (U = 1 11.88, U = 4
// 12.67), at the lateral pose's 40,000 threads (h = 1.024) 0.404 against
// 0.759 (U = 1 0.442, U = 4 0.396). At an integer h the raw order lost
// (the cube at 1000^2: 3.90-4.33 ms against window()'s 3.52-3.58, at up
// to 96 registers), so there the kernel keeps window() and kFwdSteps
// (PERF.md §6).
//
// joseph_fwd_max, the MIP render's kernel, is joseph_fwd's march with a
// compare in place of the sum. One thread per ray on the strided density it
// took 0.13 ms back to back against a 0.025 ms byte bound at 200x200, 0.62
// at the lateral pose (512 steps along the density's slowest axis;
// max_rays_timing.py, PERF.md): a serial chain of dependent window loads,
// and 40,000 threads. It now takes siddon_fwd_max's design on the bricked
// copy (fwd_max_lanes in joseph.cuh): G = kMaxLanes lanes a ray, lane j
// taking steps lo + j, lo + j + G, ..., each lane the first maximum of its
// steps by the serial strict >, then lanes.cuh's tree (the larger value,
// of two equal ones the smaller step): the serial first maximum, value and
// step bit for bit, and -1 where no sample beats 0. G = 8 and U = 1
// (kMaxSteps) from the probes: 0.068 ms at the main pose and 0.276 at the
// lateral one (G = 4 and 16 within 6%, U = 2 or 4 no faster); the same
// lanes on the strided density took 0.094 and 0.485, so the copy ships,
// though a MIP render of a new density pays it (~0.18 ms). What bounds it
// now: its march (without loads 0.042 of the 0.068 ms) and the loads.
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
// joseph_bwd_rays, the two-pass pose backward (fused_pose_bwd=False, and
// every MIP pose backward), was one thread per ray on the strided density.
// In sum mode it walked the fused march's ~133-step chain with 7
// accumulators, 4 dependent loads a step (8 at fractional h): 0.19 ms one
// call at 200x200 against a 0.025 ms byte bound (PERF.md), bound by latency
// and 40,000 threads as joseph_fwdgrad once was. Its sum mode now is
// joseph_fwdgrad's lanes (fwdgrad_lanes with N = 7 rows and g): G =
// kBwdLanes lanes a ray on the bricked copy, which the forward of the same
// density has made, each pass's summands taken in step order from +0 (a
// step outside the slab adds an exact +0, where the serial march skips
// it), then one product by g, so its rows are trace_bwd_rays' and
// joseph_fwdgrad's rows times g bit for bit (the fused and the two-pass
// pose gradients agree to the last bit). G = 8 and U = 1 (kBwdSteps) from
// bwd_rays_timing.py's probes: 0.074 ms at the main pose and 0.332 at the
// lateral one (512 steps, h = 1.024; 16 lanes 3% faster there but 8%
// slower at the main pose, U = 2 the reverse, 5% and 7%); the same lanes
// on the strided density took 0.101 and 0.449. What bounds it now: its
// march, the march without loads taking 0.062 of the 0.074 ms (PERF.md).
// MIP mode has one step of work a ray, so it stays one thread per ray on
// the strided density (joseph_bwd_rays_mip): on the copy its kernel was
// no faster (0.016 ms either way), and back to back through the wrapper,
// the copy's cache lookup included, it won at the lateral pose only.
//
// The scatters (joseph_bwd_vol, joseph_bwd_vol_ch) are laid out otherwise:
// one warp per ray (warp_scatter). Each
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
// against 87 million one thread per ray (PERF.md). A ray whose g is 0 (in
// every channel) returns at once. The order of the atomics changes from run
// to run, so the gradient's last bits do too; each add is the serial one.
//
// The channel kernels add one 4-byte label gather per step (a 7-label CT
// fits in int8, but int32 keeps the read simple) and read or write 4 * C
// bytes per ray instead of 4. One thread per ray, the two channel
// backwards were bound as the fused march was: 40,000 threads at the
// channel cell (200x200 rays, 7 channels), each a chain of ~133 steps
// whose label gather decides which cotangent is read,
// 0.27 and 0.63 ms against 0.03 and 0.05 ms byte bounds (PERF.md); the
// scatter's 32 lanes an atomic instruction were 32 rays in ~32 sectors.
// joseph_bwd_vol_ch is now the scalar scatter's warp per ray with a
// per-step cotangent (step_adds_ch_at). joseph_bwd_rays_ch is the fused
// march's lanes with each step's 7 terms times its channel's cotangent
// (channel_terms, bwd_rays_ch_lanes): G = kChannelLanes lanes a ray, U = 1,
// on the bricked copies of the density and of the labelmap (its int32 bits,
// made by the same brick_copy), the rows bit for bit the serial march's.
// G, U and the two layouts from channel_timing.py's probes (PERF.md).
//
// joseph_fwd_ch, one thread per ray on the strided density and labelmap,
// kept its C running sums in its ray's column of the output in global
// memory: each of ~133 steps a ray waited on its label gather, then read
// and wrote its channel's sum there (0.26 ms against a 0.03 ms byte bound,
// PERF.md). It now reads the bricked copies of the density and the
// labelmap, those joseph_bwd_rays_ch reads (so a render and its pose
// backward make each once), and splits each ray over G = kFwdChLanes
// lanes (fwd_ch_lanes in joseph.cuh): in passes of G steps, lane j takes
// step base + j, reading its label and window at once (channel_samples);
// the ray's lane 0 takes the pass's samples by shuffles in step order and
// adds each to its channel's sum, the sums in the block's shared memory
// ([channel][ray]) with the running sum of the last sample's channel in a
// register, so a run of samples in one structure touches shared memory
// twice. Each sum is trace_fwd_ch's += in step order from +0: the image is
// the parent's bit for bit. The block's 16 rays hold C sums each, all C in
// one march up to the opt-in limit (C <= 3632 on the H100), then tiles of
// channels, one march a tile (joseph_fwd_ch below). G = 8 and U = 1
// (kFwdChSteps) from max_channel_timing.py's probes: one thread per ray on
// the bricked copies (the sums in shared memory, U = 4) took 0.152 ms at the
// main cell and 0.94 at the lateral pose (512 planes along the density's
// slowest axis, where it lost to the strided parent's 0.73); 8 lanes take
// 0.116 and 0.407, 4 and 16 within 1-15%, U = 2 or 4 slower. Keeping the
// sums in global memory cost nothing measurable (L1 hits). What bounds it
// now: its march, the march without loads taking 0.087 of the 0.116 ms
// (PERF.md).
//
// bf16 storage (the JAX package's storage="bf16"): every kernel that reads
// the density has a second instantiation on a bf16 bricked copy (T =
// brick::bf16, the C entry points *_bf16), one template argument and one
// load overload (brick.cuh): each voxel is widened to float32 exactly, and
// the float32 kernel's arithmetic follows, so the result is the float32
// kernel's on the density rounded to bf16, bit for bit. The MIP backward
// reads the bf16 bricked copy that the MIP forward made
// (joseph_bwd_rays_mip_bf16), not the strided density. The labelmap's copy
// keeps its int32 bits; the scatters read no density and have one
// instantiation. joseph_fwd_bf16 has a trace_fwd of its own
// (joseph.cuh): each of kFwdStepsOf<bf16> = 2 steps loads its window raw
// (window_raw: 4 16-bit loads, 8 in blend mode), and only then are they
// widened and lerped across the plane pair (widen_window, window's float32
// operations in its order) and summed, so all 8 (16) loads are in flight
// together (cuobjdump -sass). A read widened where it lands (the first
// bf16 build) waited on each in turn: 0.20 ms at 200^2 against 0.10 now. 2
// steps from the probes at 1, 2, 4 and 8: even with 4 at 200^2 and 5%
// slower at the lateral pose, but 11% faster at the recon-CLI's 320,000
// rays and 10% on the cube at 1000^2, where more loads in flight cost more
// than they hide (PERF.md). The float32 forward loads its windows raw
// in blend mode only (above).
//
// joseph_fwdgrad_bf16 has a fused_terms of its own (joseph.cuh), as the
// forward has a trace_fwd: each of its U steps loads its window raw
// (window_raw: 4 16-bit loads, 8 in blend mode), and only then are they
// widened and lerped (widen_window) and the step's terms formed, in step
// order, so the rows, values and argmax steps are the float32 kernel's on
// the rounded density bit for bit. The first bf16 build widened (and in
// blend mode lerped) each read where it landed: 1 load in flight in the
// SASS, now 8U. G = kFusedLanes = 8 and U = kFusedStepsOf<bf16> = 2
// from fwdgrad_timing.py --storage bf16's probes (H100, one call): at
// the main pose (h = 1) 0.089 ms in sum mode (U = 1 the same, G = 4 and
// 16 0.089 and 0.098, U = 4 0.114 at 102 registers and 4 blocks an SM),
// 0.078 in max mode (U = 1 0.082), against the widened build's 0.104 and
// 0.102; at the lateral pose 0.305 at h = 1.024 (U = 1 0.317, widened
// 0.356) and 0.233 at h = 1 (U = 1 0.238). The march without loads takes
// 0.068 of the 0.089 ms at the main pose, the raw loads alone 0.064.
// joseph_bwd_rays_bf16's sum mode runs the same fused_terms through
// fwdgrad_lanes, so it gets the raw windows with it, untuned (kBwdLanes,
// kBwdSteps as in float32: 8 in flight; PERF.md).
//
// joseph_fwd_ch_bf16 and joseph_bwd_rays_ch_bf16 have a channel_samples
// and a channel_terms of their own (joseph.cuh): each of a lane's U steps
// loads its window raw (window_raw: 4 16-bit loads, 8 in blend mode) beside
// its label, and only then are the windows widened and lerped
// (widen_window) and the samples or terms formed, in step order (the ray
// backward gathers the U cotangents its labels pick first), so the images
// and rows are the float32 kernels' on the rounded density bit for bit. The
// labelmap's copy keeps its int32 bits and label_at its plane rule. The
// first bf16 build widened (and in blend mode lerped) each read where it
// landed: 1 load in flight in the SASS, now 8 (4U, 8U in blend mode). G and
// U by storage (kFwdChLanesOf<T>, kFwdChStepsOf<T>, kChannelLanesOf<T>,
// kChannelStepsOf<T>) from the --storage bf16 probes of
// max_channel_timing.py and channel_timing.py at G = 4, 8, 16 and U = 1, 2,
// 4 (H100, one call). The forward: G = 4, U = 1, 0.107 ms at the main pose
// (G = 8 0.113, G = 16 0.144; U = 2 the same, U = 4 5% slower at 94
// registers and 5 blocks an SM), 0.359 at the lateral pose at h = 1.024 and
// 0.296 at h = 1 (G = 8 0.375 and 0.310), where the widened build at the
// parent's G = 8 took 0.119, 0.407 and 0.323; the march without loads
// takes 0.079 of its 0.107 ms. At G = 4 a block holds 32 rays' sums, so all
// C channels fit one march up to C = 1816. The ray backward: G = 8, U = 1,
// 0.095 ms at the main pose (G = 16 0.098, U = 2 0.100, U = 4 0.119),
// 0.339 at the lateral pose at h = 1.024 and 0.273 at h = 1, where the
// widened build at the parent's G = 16 took 0.113, 0.387 and 0.285; its
// march without loads 0.074 of the 0.095 ms. The float32 kernels keep their
// G (8, 16), U = 1 and their SASS (PERF.md).
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "joseph.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kThreads == joseph::kFusedThreads,
              "the fused kernel's hand-over is sized for its blocks");

// One thread per ray, reading the bricked copy with kFwdStepsOf<T> steps'
// loads in flight; Blend (the float32 copy at a fractional h): kFwdBlendSteps
// steps' windows loaded raw before any is lerped (trace_fwd_raw). The note
// at the top of this file says why; A: the march axis.
template <int A, class T, bool Blend = false>
__global__ void __launch_bounds__(kThreads)
joseph_fwd_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A, T> vol,
                  joseph::March m, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  joseph::Ray ray = joseph::load_ray(rows, n_rays, r);
  if constexpr (Blend)
    out[r] = joseph::trace_fwd_raw<joseph::kFwdBlendSteps>(ray, vol, m);
  else
    out[r] = joseph::trace_fwd<joseph::kFwdStepsOf<T>>(ray, vol, m);
}

// G = kMaxLanes lanes a ray on the bricked copy, each lane the first
// maximum of its steps, then the lanes' tree (fwd_max_lanes; the note at the
// top of this file says why); A: the march axis.
template <int A, class T>
__global__ void __launch_bounds__(kThreads)
joseph_fwd_max_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A, T> vol,
                      joseph::March m, float* __restrict__ out, int* __restrict__ arg) {
  joseph::fwd_max_lanes<joseph::kMaxLanes, joseph::kMaxSteps>(
      rows, n_rays, vol, m, out, arg, (int64_t)blockIdx.x * kThreads + threadIdx.x);
}

// G = kFusedLanes lanes a ray on the bricked copy, in passes of G * U steps
// (U = kFusedStepsOf<T>) whose summands the ray's rows take in step order
// (lanes.cuh; the note at the top of this file says why); A: the march
// axis. arg == nullptr: sum mode; else MIP, the argmax step written to
// arg[r].
template <int A, class T>
__global__ void __launch_bounds__(kThreads)
joseph_fwdgrad_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A, T> vol,
                      joseph::March m, float* __restrict__ out, int* __restrict__ arg) {
  joseph::fwdgrad_lanes<joseph::kFusedLanes, joseph::kFusedStepsOf<T>>(
      rows, n_rays, vol, m, out, arg, (int64_t)blockIdx.x * kThreads + threadIdx.x);
}

// The two-pass pose backward in sum mode: G = kBwdLanes lanes a ray on the
// bricked copy, in passes of G steps whose summands the ray's rows take in
// step order, then one product by g (fwdgrad_lanes; the note at the top of
// this file says why); A: the march axis.
template <int A, class T>
__global__ void __launch_bounds__(kThreads)
joseph_bwd_rays_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A, T> vol,
                       joseph::March m, const float* __restrict__ g, float* __restrict__ out) {
  joseph::fwdgrad_lanes<joseph::kBwdLanes, joseph::kBwdSteps, joseph::kRows>(
      rows, n_rays, vol, m, out, nullptr, (int64_t)blockIdx.x * kThreads + threadIdx.x, g);
}

// MIP: one thread per ray on the strided density (Vol = joseph::Volume), or
// on the bf16 bricked copy (a brick::Volume), gated to the step arg[r] (one
// step of work: lanes would idle; the note at the top of this file says why
// not the float32 copy).
template <class Vol>
__global__ void __launch_bounds__(kThreads)
joseph_bwd_rays_mip_kernel(const float* __restrict__ rows, int64_t n_rays, Vol vol,
                           joseph::March m, const float* __restrict__ g,
                           const int* __restrict__ arg, float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  float acc[joseph::kRows];
  joseph::trace_bwd_rays(joseph::load_ray(rows, n_rays, r), vol, m, g[r], arg[r], true, acc);
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

// A warp's scatter of one ray's steps [lo, hi) (the whole warp calls it).
// Each pass takes 32 neighbouring steps of the ray, step lo + l (then
// lo + l + 32, ...) on lane l, whose adds adds(p, off, x) computes (a
// step_adds mask); the warp lays the pass's adds out in shared memory in
// path order (step, then neighbour) and issues them 32 at a time, so each
// atomic instruction covers 32 consecutive adds along the ray.
template <class Adds>
__device__ __forceinline__ void warp_scatter(int lo, int hi, float* __restrict__ grad,
                                             Adds adds) {
  __shared__ int64_t s_off[kWarpsPerBlock][joseph::kStepAdds * kWarp];
  __shared__ float s_x[kWarpsPerBlock][joseph::kStepAdds * kWarp];
  int lane = threadIdx.x % kWarp;
  int w = threadIdx.x / kWarp;
  for (int base = lo; base < hi; base += kWarp) {
    int64_t off[joseph::kStepAdds];
    float x[joseph::kStepAdds];
    int p = base + lane;
    unsigned mask = p < hi ? adds(p, off, x) : 0u;
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
    for (int k = lane; k < total; k += kWarp) atomicAdd(grad + s_off[w][k], s_x[w][k]);
    __syncwarp();
  }
}

// One warp per ray, its steps' adds from step_adds_at (warp_scatter). In
// MIP mode the ray has at most one step.
__global__ void __launch_bounds__(kThreads)
joseph_bwd_vol_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::March m,
                      const float* __restrict__ g, const int* __restrict__ arg,
                      joseph::GradVolume grad) {
  int64_t r = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kWarp;
  if (r >= n_rays) return;  // the whole warp: r is the warp's
  joseph::Ray ray = joseph::load_ray(rows, n_rays, r);
  float gr = g[r];
  if (gr == 0.f) return;  // every add is a product by g: none to make
  int lo, hi;
  joseph::scatter_range(ray, m, arg ? arg[r] : -1, arg != nullptr, &lo, &hi);
  warp_scatter(lo, hi, grad.data, [&](int p, int64_t* off, float* x) {
    return joseph::step_adds_at(ray, grad, m, p, gr, off, x);
  });
}

// G = kFwdChLanesOf<T> lanes a ray on the bricked copies of the density
// and the labelmap, in passes of G * U steps (U = kFwdChStepsOf<T>) whose
// samples the ray's lane 0 adds in step order to its channel sums
// (fwd_ch_lanes; the note at the top of this file says why), the block's
// kThreads / G rays' sums in its dynamic shared memory, [channel][ray]; the
// channels in tiles of `tile` (all C in one unless the block's sums
// overflow its shared memory: joseph_fwd_ch below). A: the march axis.
template <int A, class T>
__global__ void __launch_bounds__(kThreads)
joseph_fwd_ch_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A, T> vol,
                     joseph::BrickLabels<A> lab, joseph::March m, int n_channels, int tile,
                     float* __restrict__ out) {
  constexpr int G = joseph::kFwdChLanesOf<T>;
  constexpr int kRays = kThreads / G;  // a block's rays
  extern __shared__ float sums[];      // [tile][kRays]
  joseph::fwd_ch_lanes<G, joseph::kFwdChStepsOf<T>>(
      rows, n_rays, vol, lab, m, n_channels, tile, sums + threadIdx.x / G, kRays, out,
      (int64_t)blockIdx.x * kThreads + threadIdx.x);
}

// G = kChannelLanesOf<T> lanes a ray on the bricked copies of the density
// and the labelmap, in passes of G * U steps (U = kChannelStepsOf<T>) whose
// summands the ray's rows take in step order (bwd_rays_ch_lanes; the note
// at the top of this file says why); A: the march axis.
template <int A, class T>
__global__ void __launch_bounds__(kThreads)
joseph_bwd_rays_ch_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A, T> vol,
                          joseph::BrickLabels<A> lab, joseph::March m, int n_channels,
                          const float* __restrict__ g, float* __restrict__ out) {
  joseph::bwd_rays_ch_lanes<joseph::kChannelLanesOf<T>, joseph::kChannelStepsOf<T>>(
      rows, n_rays, vol, lab, m, n_channels, g, out,
      (int64_t)blockIdx.x * kThreads + threadIdx.x);
}

// One warp per ray, its steps' adds from step_adds_ch_at (warp_scatter). A
// ray whose cotangent is 0 in every channel returns at once.
__global__ void __launch_bounds__(kThreads)
joseph_bwd_vol_ch_kernel(const float* __restrict__ rows, int64_t n_rays, joseph::Labels lab,
                         joseph::March m, int n_channels, const float* __restrict__ g,
                         joseph::GradVolume grad) {
  int64_t r = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kWarp;
  int lane = threadIdx.x % kWarp;
  if (r >= n_rays) return;  // the whole warp: r is the warp's
  const float* gr = g + r;  // the ray's cotangent column
  bool any = false;
  for (int c = lane; c < n_channels; c += kWarp) any |= gr[(int64_t)c * n_rays] != 0.f;
  if (!__any_sync(kFullMask, any)) return;  // every add is a product by g: none to make
  joseph::Ray ray = joseph::load_ray(rows, n_rays, r);
  int lo, hi;
  joseph::step_range(ray, m, &lo, &hi);
  warp_scatter(lo, hi, grad.data, [&](int p, int64_t* off, float* x) {
    return joseph::step_adds_ch_at(ray, grad, lab, m, p, n_channels, gr, n_rays, off, x);
  });
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

// The entry points on a bricked copy of element type T, for march axis
// `axis` (-1 for an axis outside 0..2): launch(A, the copy's volume) launches
// the kernel and returns a CUDA error code.
template <class T, class Launch>
int on_copy(const T* vol, int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
            Launch launch) {
  return brick::with_axis(axis, [&](auto a) {
    constexpr int A = decltype(a)::value;
    int rc = launch(a, brick::make_volume<A>(vol, bs_s, bs_y, bs_z, X, Y, Z));
    return rc != 0 ? rc : (int)cudaGetLastError();
  });
}

template <class T>
int fwd(const float* rows, int64_t n_rays, const T* vol, int axis, int bs_s, int bs_y,
        int bs_z, int X, int Y, int Z, float h, int n_steps, int blend, float* out,
        void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto a, auto v) {
    constexpr int A = decltype(a)::value;
    if (n_rays <= 0) return 0;
    joseph::March m = make_march(h, n_steps, blend);
    auto launch = [&](auto kernel) {
      kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(rows, n_rays, v, m, out);
    };
    if constexpr (std::is_same<T, float>::value) {
      if (m.blend) {
        launch(joseph_fwd_kernel<A, T, true>);
        return 0;
      }
    }
    launch(joseph_fwd_kernel<A, T>);
    return 0;
  });
}

template <class T>
int fwd_max(const float* rows, int64_t n_rays, const T* vol, int axis, int bs_s, int bs_y,
            int bs_z, int X, int Y, int Z, float h, int n_steps, int blend, float* out, int* arg,
            void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto a, auto v) {
    if (n_rays > 0) {
      joseph_fwd_max_kernel<decltype(a)::value, T>
          <<<n_blocks(n_rays * joseph::kMaxLanes), kThreads, 0, (cudaStream_t)stream>>>(
              rows, n_rays, v, make_march(h, n_steps, blend), out, arg);
    }
    return 0;
  });
}

template <class T>
int fwdgrad(const float* rows, int64_t n_rays, const T* vol, int axis, int bs_s, int bs_y,
            int bs_z, int X, int Y, int Z, float h, int n_steps, int blend, float* out, int* arg,
            void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto a, auto v) {
    if (n_rays > 0) {
      joseph_fwdgrad_kernel<decltype(a)::value, T>
          <<<n_blocks(n_rays * joseph::kFusedLanes), kThreads, 0, (cudaStream_t)stream>>>(
              rows, n_rays, v, make_march(h, n_steps, blend), out, arg);
    }
    return 0;
  });
}

template <class T>
int bwd_rays(const float* rows, int64_t n_rays, const T* vol, int axis, int bs_s, int bs_y,
             int bs_z, int X, int Y, int Z, float h, int n_steps, int blend, const float* g,
             float* out, void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto a, auto v) {
    if (n_rays > 0) {
      joseph_bwd_rays_kernel<decltype(a)::value, T>
          <<<n_blocks(n_rays * joseph::kBwdLanes), kThreads, 0, (cudaStream_t)stream>>>(
              rows, n_rays, v, make_march(h, n_steps, blend), g, out);
    }
    return 0;
  });
}

template <class Vol>
int bwd_rays_mip(const float* rows, int64_t n_rays, Vol vol, float h, int n_steps, int blend,
                 const float* g, const int* arg, float* out, void* stream) {
  if (n_rays > 0) {
    joseph_bwd_rays_mip_kernel<Vol><<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, vol, make_march(h, n_steps, blend), g, arg, out);
  }
  return (int)cudaGetLastError();
}

// joseph_fwd_ch's block holds C float sums for each of its kThreads / G
// rays (G = kFwdChLanesOf<T>) in shared memory: all C channels in one march
// while they fit the block's opt-in limit (227 KB on the H100: C <= 3632
// at G = 8, 1816 at G = 4), else tiles of as many as fit, one march a
// tile. Any C >= 1 runs. G sizes the grid (G threads a ray), the block's
// rays and so the tile together.
template <class T>
int fwd_ch(const float* rows, int64_t n_rays, const T* vol, const float* labels, int axis,
           int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float h, int n_steps, int blend,
           int n_channels, float* out, void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto a, auto v) {
    constexpr int A = decltype(a)::value;
    constexpr int G = joseph::kFwdChLanesOf<T>;
    constexpr int kRays = kThreads / G;
    if (n_rays <= 0 || n_channels <= 0) return 0;
    int dev, limit;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    int tile = (int)std::min<int64_t>(n_channels, limit / (kRays * (int)sizeof(float)));
    size_t bytes = (size_t)tile * kRays * sizeof(float);
    if (bytes > 48 * 1024) {  // above the default, the kernel must opt in
      err = cudaFuncSetAttribute(joseph_fwd_ch_kernel<A, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    joseph_fwd_ch_kernel<A, T>
        <<<n_blocks(n_rays * G), kThreads, bytes, (cudaStream_t)stream>>>(
            rows, n_rays, v,
            joseph::BrickLabels<A>{brick::make_volume<A>(labels, bs_s, bs_y, bs_z, X, Y, Z)},
            make_march(h, n_steps, blend), n_channels, tile, out);
    return 0;
  });
}

template <class T>
int bwd_rays_ch(const float* rows, int64_t n_rays, const T* vol, const float* labels, int axis,
                int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float h, int n_steps,
                int blend, int n_channels, const float* g, float* out, void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto a, auto v) {
    constexpr int A = decltype(a)::value;
    if (n_rays > 0) {
      joseph_bwd_rays_ch_kernel<A, T>
          <<<n_blocks(n_rays * joseph::kChannelLanesOf<T>), kThreads, 0,
             (cudaStream_t)stream>>>(
              rows, n_rays, v,
              joseph::BrickLabels<A>{brick::make_volume<A>(labels, bs_s, bs_y, bs_z, X, Y, Z)},
              make_march(h, n_steps, blend), n_channels, g, out);
    }
    return 0;
  });
}

}  // namespace

// Plain C interface (loaded with ctypes). rows: (9, n_rays) float32; vol: the
// density with element strides (ss, sy, sz) of the march-permuted axes and
// extents (X, Y, Z); the march: n_steps samples at k = p * h, blend != 0 for
// a fractional h (h is the float32 rounding of the caller's stride); out:
// (n_rays,) for joseph_fwd, (n_rays,) values and (n_rays,) int32 steps for
// joseph_fwd_max, (8, n_rays) for joseph_fwdgrad, (7, n_rays) for
// joseph_bwd_rays and joseph_bwd_rays_mip; g: (n_rays,) float32; arg:
// (n_rays,) int32 argmax steps (joseph_bwd_rays_mip; joseph_bwd_vol: MIP,
// or NULL for sum mode; joseph_fwdgrad writes it in max mode, NULL in sum
// mode); grad: a zero-filled float32 volume with the density's extents and
// its own strides (gs, gy, gz) in the same permuted order. Each launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
// joseph_fwd, joseph_fwd_max, joseph_fwdgrad and joseph_bwd_rays (sum
// mode) read the density's bricked copy (brick.cuh) instead: vol is the
// copy, axis the march axis, then the brick strides and the density's
// extents of the march-permuted (s, y, z) axes. They return -1 for an axis
// outside 0..2. The *_bf16 entry points take the same arguments with a
// bf16 bricked copy as vol; joseph_bwd_rays_mip_bf16 takes joseph_bwd_rays'
// copy arguments (the bf16 copy) in place of the strided density's.
extern "C" int joseph_fwd(const float* rows, int64_t n_rays, const float* vol, int axis,
                          int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float h,
                          int n_steps, int blend, float* out, void* stream) {
  return fwd(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps, blend, out, stream);
}

extern "C" int joseph_fwd_bf16(const float* rows, int64_t n_rays, const brick::bf16* vol,
                               int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                               float h, int n_steps, int blend, float* out, void* stream) {
  return fwd(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps, blend, out, stream);
}

extern "C" int joseph_fwd_max(const float* rows, int64_t n_rays, const float* vol, int axis,
                              int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float h,
                              int n_steps, int blend, float* out, int* arg, void* stream) {
  return fwd_max(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps, blend, out, arg,
                 stream);
}

extern "C" int joseph_fwd_max_bf16(const float* rows, int64_t n_rays, const brick::bf16* vol,
                                   int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                                   float h, int n_steps, int blend, float* out, int* arg,
                                   void* stream) {
  return fwd_max(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps, blend, out, arg,
                 stream);
}

extern "C" int joseph_fwdgrad(const float* rows, int64_t n_rays, const float* vol, int axis,
                              int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float h,
                              int n_steps, int blend, float* out, int* arg, void* stream) {
  return fwdgrad(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps, blend, out, arg,
                 stream);
}

extern "C" int joseph_fwdgrad_bf16(const float* rows, int64_t n_rays, const brick::bf16* vol,
                                   int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                                   float h, int n_steps, int blend, float* out, int* arg,
                                   void* stream) {
  return fwdgrad(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps, blend, out, arg,
                 stream);
}

extern "C" int joseph_bwd_rays(const float* rows, int64_t n_rays, const float* vol, int axis,
                               int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float h,
                               int n_steps, int blend, const float* g, float* out,
                               void* stream) {
  return bwd_rays(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps, blend, g, out,
                  stream);
}

extern "C" int joseph_bwd_rays_bf16(const float* rows, int64_t n_rays, const brick::bf16* vol,
                                    int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                                    float h, int n_steps, int blend, const float* g, float* out,
                                    void* stream) {
  return bwd_rays(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps, blend, g, out,
                  stream);
}

extern "C" int joseph_bwd_rays_mip(const float* rows, int64_t n_rays, const float* vol,
                                   int64_t ss, int64_t sy, int64_t sz, int X, int Y, int Z,
                                   float h, int n_steps, int blend, const float* g,
                                   const int* arg, float* out, void* stream) {
  return bwd_rays_mip(rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z), h, n_steps, blend, g,
                      arg, out, stream);
}

extern "C" int joseph_bwd_rays_mip_bf16(const float* rows, int64_t n_rays,
                                        const brick::bf16* vol, int axis, int bs_s, int bs_y,
                                        int bs_z, int X, int Y, int Z, float h, int n_steps,
                                        int blend, const float* g, const int* arg, float* out,
                                        void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto, auto v) {
    return bwd_rays_mip(rows, n_rays, v, h, n_steps, blend, g, arg, out, stream);
  });
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
// joseph_bwd_rays_ch; g: (C, n_rays) float32. joseph_fwd_ch and
// joseph_bwd_rays_ch read the bricked copies of the density (vol; bf16 in
// the *_bf16 entry points) and of the labelmap (labels, its int32 bits),
// which share the arguments that follow them, those of joseph_fwdgrad (and
// return -1 for an axis outside 0..2).
extern "C" int joseph_fwd_ch(const float* rows, int64_t n_rays, const float* vol,
                             const float* labels, int axis, int bs_s, int bs_y, int bs_z, int X,
                             int Y, int Z, float h, int n_steps, int blend, int n_channels,
                             float* out, void* stream) {
  return fwd_ch(rows, n_rays, vol, labels, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps, blend,
                n_channels, out, stream);
}

extern "C" int joseph_fwd_ch_bf16(const float* rows, int64_t n_rays, const brick::bf16* vol,
                                  const float* labels, int axis, int bs_s, int bs_y, int bs_z,
                                  int X, int Y, int Z, float h, int n_steps, int blend,
                                  int n_channels, float* out, void* stream) {
  return fwd_ch(rows, n_rays, vol, labels, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps, blend,
                n_channels, out, stream);
}

extern "C" int joseph_bwd_rays_ch(const float* rows, int64_t n_rays, const float* vol,
                                  const float* labels, int axis, int bs_s, int bs_y, int bs_z,
                                  int X, int Y, int Z, float h, int n_steps, int blend,
                                  int n_channels, const float* g, float* out, void* stream) {
  return bwd_rays_ch(rows, n_rays, vol, labels, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps,
                     blend, n_channels, g, out, stream);
}

extern "C" int joseph_bwd_rays_ch_bf16(const float* rows, int64_t n_rays,
                                       const brick::bf16* vol, const float* labels, int axis,
                                       int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float h,
                                       int n_steps, int blend, int n_channels, const float* g,
                                       float* out, void* stream) {
  return bwd_rays_ch(rows, n_rays, vol, labels, axis, bs_s, bs_y, bs_z, X, Y, Z, h, n_steps,
                     blend, n_channels, g, out, stream);
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
    joseph_bwd_vol_ch_kernel<<<n_blocks(n_rays * kWarp), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_labels(labels, ls, ly, lz, X, Y, Z), make_march(h, n_steps, blend),
        n_channels, g, gv);
  }
  return (int)cudaGetLastError();
}
