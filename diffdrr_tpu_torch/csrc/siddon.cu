// CUDA kernels for exact Siddon ray integration by slab march (sm_90a).
//
// siddon_fwd replaces the TPU kernels _fwd_kernel (sum mode) and
// _fwd_plane_major_kernel of diffdrr_tpu/ops/pallas/siddon.py: both compute
// the same line integral, the TPU choosing between them by whether the
// volume fits its VMEM. siddon_fwdgrad replaces _fwdgrad_kernel: one march
// that emits the value and the 9 cotangent-free gradient rows, so the pose
// backward is an elementwise rows * g. siddon_fwd_max replaces _fwd_kernel's
// max mode (the MIP value and its argmax), siddon_bwd_rays replaces
// _bwd_rays_kernel (the two-pass pose backward, sum or MIP) and
// siddon_bwd_vol replaces _bwd_vol_kernel (the density gradient).
//
// Design: one thread per ray (the fused march, the MIP forward, the
// two-pass backward's sum mode and the scatter aside, below), walking only
// its own slabs (slab_range in siddon.cuh) and reading the <= 3 voxels of
// each slab straight from the float32 volume through its strides (the
// forwards siddon_fwd and siddon_fwd_max, the fused march and the two-pass
// backward's sum mode: its bricked copy). The TPU needed
// tile windows, a starts table, one-hot matmuls and a permuted, padded copy
// of the volume to turn these gathers into MXU work; on the H100 a gather
// is a load, so none of that is carried over. A MIP backward visits only
// the argmax slab.
//
// What bounds the gathering kernels: per ray and slab, one to three 4-byte
// gathers at data-dependent addresses (about 175 flops of per-slab algebra
// for the gradient rows, about 50 for a value). The bytes a render must
// move are the voxels its rays touch (at most the volume: 139 MB for the
// 512x512x133 CT, 537 MB for 512^3, both above the 50 MB L2) plus 36 bytes
// of rows in and 4 (fwd), 8 (fwd_max), 36 (bwd_rays) or 40 (fwdgrad) bytes
// out per ray; against 3.35 TB/s that is tens of microseconds. The simple
// design is instead bound by gather latency: neighbouring threads are
// neighbouring detector pixels, so a warp's 32 rays read neighbouring
// voxels of the same slab at the same step (the rays of a warp advance in
// lock step through the slabs) and L1/L2 serve most of those reads, but
// each thread waits on its own dependent loads, and a 200x200 detector
// gives only 40,000 threads, a small fraction of the card's 270,336
// resident threads. Tiling rays per block and staging slab windows in
// shared memory is later work (PERF.md).
//
// siddon_fwd reads the density's bricked copy instead (brick.cuh, made by
// brick.cu once per version of the density). What bounded it on the
// strided density: in the recon cells the march axis is the density's
// unit-stride axis, so a warp's 32 rays read 32 columns at each slab, ~32
// cache lines a load; its loads alone took 0.95 ms at the recon's 320,000
// rays (fwd_timing.py's probes, PERF.md). On 4x4x4 bricks (two lines each)
// those rays fall in a few bricks (loads alone 0.55 ms), and each thread
// keeps kFwdSlabs = 4 slabs' loads in flight before adding them in slab
// order, so the value is bit for bit the strided serial one. The brick
// shape is a compile-time constant (brick.cuh), so a voxel's address costs
// constant shifts and masks and one multiply a brick stride. What bounds
// it now: the march's own arithmetic, two IEEE divisions a slab (the march
// without loads takes 0.33 ms of the kernel's 0.41-0.43). At 1000x1000 on
// the 512^3 CT, rays ~0.4 voxel apart, the march is most of the time and
// the kernel is still ~12% slower than the strided one (PERF.md, open
// questions).
//
// siddon_fwd_max, the MIP render's kernel, is siddon_fwd's march with a
// compare in place of the sum. One thread per ray on the strided density it
// took 0.24 ms against a 0.011 ms byte bound at 200x200 (PERF.md), and on
// the bricked copy with kFwdSlabs slabs in flight it was no faster (0.18
// ms; one slab in flight 0.14, as the strided kernel): the march's two
// divisions a slab bound it, not the loads. So it reads the bricked copy
// (the one every render of the CT shares) and splits each ray over G =
// kMaxLanes lanes (fwd_max_lanes in siddon.cuh): lane j takes slabs
// lo + j, lo + j + G, ..., keeps the first maximum of its own by the
// strict >, and the ray's lanes combine in lanes.cuh's tree (the larger
// value, of two equal ones the smaller code): the serial first maximum,
// value and code bit for bit. No hand-over is needed, as a maximum does not
// depend on the order it is taken in. G = 8 and U = 1 (kMaxSlabs) from
// max_channel_timing.py's probes: 0.071 ms at the main cell, 0.165 at the
// lateral pose (512 slabs), G = 4, 16 and 32 within 3-14%, U = 2 or 4
// slower. What bounds it now: its march (the march without loads takes
// 0.062 of the 0.071 ms, PERF.md).
//
// siddon_fwdgrad, the registration step's kernel, also reads the bricked
// copy, and splits each ray over G = kFusedLanes lanes (siddon.cuh). What
// bounded it one thread per ray on the strided density: the main cell's
// 200x200 detector gives 40,000 threads, ~15% of the card's resident
// threads, and each walked a serial chain of ~135 slabs, each ~113 float
// operations with two IEEE divisions ahead of its 3 dependent loads, with
// 10 accumulators live: latency and occupancy, not bytes, set its time
// (0.195 ms against a 0.011 ms byte bound, PERF.md). Here the ray's march
// goes in passes of G slabs, lane j taking slab base + j: G times the
// threads, each with 1/G of the chain, and neighbouring lanes read
// neighbouring slabs of one ray, which share one or two bricks. Each pass
// hands the lanes' summands over through shared memory and the ray's rows
// take them in slab order, lane k % G adding row k (lanes.cuh): the rows are
// the serial march's bit for bit, so they equal the plain version's and the
// two-pass backward's (siddon_bwd_rays) as before, and repeat run to run.
// A tree of partial sums instead was ~7% faster, but left the pose
// gradient of the two paths 1.3e-5 of its largest value apart. G = 8 and
// U = 1 (kFusedSlabs) come from fwdgrad_timing.py's probes: 16 lanes were
// within 1%, 32 slower, and 2 or 4 slabs in flight no faster. What bounds
// it now: its march's arithmetic (the march without loads takes 0.091 of
// the kernel's 0.099 ms at 200x200, PERF.md).
//
// siddon_bwd_rays, the two-pass pose backward (fused_pose_bwd=False, and
// every MIP pose backward), was one thread per ray on the strided density.
// In sum mode it walked the fused march's ~135-slab chain with 9
// accumulators: 0.149 ms back to back at 200x200 against a 0.011 ms byte
// bound, 0.44 at the lateral pose (max_rays_timing.py, PERF.md), as
// siddon_fwdgrad once was. Its sum mode now is siddon_fwdgrad's lanes
// (fwdgrad_lanes with N = 9 rows and g): G = kBwdLanes lanes a ray on the
// bricked copy, which the forward of the same density has made, each
// pass's summands taken in slab order, then one product by g, so its rows
// are trace_bwd_rays' and siddon_fwdgrad's rows times g bit for bit (the
// fused and the two-pass pose gradients agree to the last bit). G = 8 and
// U = 1 (kBwdSlabs) from the probes: 0.093 ms and 0.265 (16 lanes and
// U = 2 within 2%; the strided density as fast, within 4%: the march
// without loads takes 0.076 of the 0.093 ms and bounds it). MIP mode has
// one slab of work a ray, so it stays one thread per ray on the strided
// density: on the copy the kernel alone was ~5-9% faster (0.013 against
// 0.015 ms), but the wrapper's lookup of the cached copy cost more host
// time than that, and a call back to back was slower at both poses.
//
// The scatter (siddon_bwd_vol) is laid out otherwise: one warp per ray.
// It adds len * w * g for each non-empty segment into the f32 gradient,
// which the wrapper zero-fills, with a float atomicAdd. The bytes it must
// move are the gradient written once (139.5 MB for the 512x512x133 CT, 42
// us at 3.35 TB/s). What bounds it instead is the L2's atomic requests: a
// warp instruction costs one request per 32-byte sector its lanes touch.
// With one thread per ray, a warp's 32 rays hit 32 voxels of one slab,
// voxels in 32 different sectors. Here lane l of a warp takes slab lo + l
// of one ray (then lo + l + 32, ...), and the warp lays a pass's adds out
// in shared memory in path order and issues them 32 at a time. With the
// march axis the gradient's unit-stride axis (the reconstruction views),
// a run of the ray's voxels in one column is one sector. The fan's slopes
// end a run every ~1.4 slabs, so an instruction still touches many
// sectors: 33 million requests for the recon's 65 million adds, against
// 65 million one thread per ray (PERF.md). The march (slab_segments per
// slab) is the same work in either layout. A ray whose g is 0 returns at
// once. The order in which the atomics land changes from run to run, so
// the gradient is nondeterministic in its last bits: compare it with a
// tolerance, never bit for bit.
//
// bf16 storage (the JAX package's storage="bf16"): every kernel that reads
// the bricked copy has a second instantiation on a bf16 copy (T =
// brick::bf16, the C entry points *_bf16), which widens each voxel to
// float32 exactly and then does the float32 kernel's arithmetic, so it
// gives the float32 kernel's result on the density rounded to bf16, bit
// for bit. The MIP backward reads the bf16 bricked copy that the MIP
// forward made (siddon_bwd_rays_mip_bf16), not the strided density, so the
// rounded values need no second copy. The scatter reads no density and has
// one instantiation. siddon_fwd_bf16 keeps its reads raw: trace_fwd types
// its V[U][3] by the copy's element (read_raw), so the kFwdSlabs = 4
// slabs' 12 16-bit loads all issue before the sums widen the first of
// them (cuobjdump -sass: 12 in flight, as the float32 build's 12 floats).
// A read widened where it lands (the first bf16 build, brick::load) makes
// the thread wait on each load in turn: 0.19-0.20 ms at 200^2 against
// 0.10-0.11 now (fwd_timing.py's probes, PERF.md). 4 slabs from the probes
// at 1, 2, 4 and 8: 8 is 2-7% faster at 200^2 and 3-7% slower at 320,000
// rays and on the cube at 1000^2. The raw reads leave the float32
// instantiation's code as it was, instruction for instruction
// (sass_check.py).
//
// siddon_fwdgrad_bf16 keeps its reads raw too: fused_terms reads each
// slab's three voxels as the copy stores them (segment_raw: voxel_raw on a
// bf16 copy, with the s < hi gate and no zero-length one, since a
// segment's value enters the crossings' terms) and widens them only once
// every load of its U slabs has issued, then forms the rows by the float32
// operations, so they are the float32 kernel's on the rounded density bit
// for bit. The first bf16 build widened each read where it landed
// (brick::load), which made the lane wait on each of its 3 loads in turn
// (cuobjdump -sass: 1 in flight; now 3U). G = kFusedLanes = 8 and
// U = kFusedSlabsOf<bf16> = 1 from fwdgrad_timing.py --storage bf16's
// probes (H100, 200^2 main pose, one call): raw 0.100 ms against the
// widened build's 0.110; U = 2 0.105 and U = 4 0.127 (63 and 76 registers
// against 56, 8 and 6 blocks an SM against 9); G = 4 and 16 0.110 and
// 0.106; at the lateral pose (512 slabs) 0.277, U = 2 within 1%, widened
// 0.289. The march without loads takes 0.088 of the 0.100 ms: it bounds
// the kernel, as in float32. siddon_bwd_rays_bf16's sum mode runs the same
// fused_terms through fwdgrad_lanes, so it gets the raw reads with it,
// untuned (kBwdLanes, kBwdSlabs as in float32; PERF.md).
#include <cuda_runtime.h>

#include "siddon.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kThreads == siddon::kFusedThreads,
              "the fused kernel's hand-over is sized for its blocks");

// One thread per ray, reading the bricked copy with kFwdSlabs slabs' loads
// in flight (the note at the top of this file says why); A: the march axis.
template <int A, class T>
__global__ void __launch_bounds__(kThreads)
siddon_fwd_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A, T> vol,
                  float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  siddon::Ray ray = siddon::load_ray(rows, n_rays, r);
  out[r] = siddon::trace_fwd<siddon::kFwdSlabs>(ray, vol);
}

// G = kFusedLanes lanes a ray on the bricked copy, in passes of G * U slabs
// (U = kFusedSlabsOf<T>) whose summands the ray's rows take in slab order
// (lanes.cuh; the note at the top of this file says why); A: the march axis.
template <int A, class T>
__global__ void __launch_bounds__(kThreads)
siddon_fwdgrad_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A, T> vol,
                      float* __restrict__ out) {
  siddon::fwdgrad_lanes<siddon::kFusedLanes, siddon::kFusedSlabsOf<T>>(
      rows, n_rays, vol, out, (int64_t)blockIdx.x * kThreads + threadIdx.x);
}

// G = kMaxLanes lanes a ray on the bricked copy, each lane the first
// maximum of its slabs, then the lanes' tree (fwd_max_lanes; the note at the
// top of this file says why); A: the march axis.
template <int A, class T>
__global__ void __launch_bounds__(kThreads)
siddon_fwd_max_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A, T> vol,
                      float* __restrict__ out, int* __restrict__ arg) {
  siddon::fwd_max_lanes<siddon::kMaxLanes, siddon::kMaxSlabs>(
      rows, n_rays, vol, out, arg, (int64_t)blockIdx.x * kThreads + threadIdx.x);
}

// The two-pass pose backward in sum mode: G = kBwdLanes lanes a ray on the
// bricked copy, in passes of G slabs whose summands the ray's rows take in
// slab order, then one product by g (fwdgrad_lanes; the note at the top of
// this file says why); A: the march axis.
template <int A, class T>
__global__ void __launch_bounds__(kThreads)
siddon_bwd_rays_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A, T> vol,
                       const float* __restrict__ g, float* __restrict__ out) {
  siddon::fwdgrad_lanes<siddon::kBwdLanes, siddon::kBwdSlabs, siddon::kRows>(
      rows, n_rays, vol, out, (int64_t)blockIdx.x * kThreads + threadIdx.x, g);
}

// MIP: one thread per ray on the strided density (Vol = siddon::Volume), or
// on the bf16 bricked copy (a brick::Volume), gated to the slab and segment
// arg[r] (one slab of work: lanes would idle; the note at the top of this
// file says why not the float32 copy).
template <class Vol>
__global__ void __launch_bounds__(kThreads)
siddon_bwd_rays_mip_kernel(const float* __restrict__ rows, int64_t n_rays, Vol vol,
                           const float* __restrict__ g, const int* __restrict__ arg,
                           float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  float acc[siddon::kRows];
  siddon::trace_bwd_rays(siddon::load_ray(rows, n_rays, r), vol, g[r], arg[r], true, acc);
#pragma unroll
  for (int k = 0; k < siddon::kRows; ++k) out[k * n_rays + r] = acc[k];
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

// One warp per ray. Each pass takes 32 neighbouring slabs of the ray, slab
// lo + l (then lo + l + 32, ...) on lane l, whose adds slab_adds computes;
// the warp lays the pass's adds out in shared memory in path order (slab,
// then segment) and issues them 32 at a time, so each atomic instruction
// covers 32 consecutive voxels of the ray's path. In MIP mode the ray has
// at most one slab.
__global__ void __launch_bounds__(kThreads)
siddon_bwd_vol_kernel(const float* __restrict__ rows, int64_t n_rays,
                      const float* __restrict__ g, const int* __restrict__ arg,
                      siddon::GradVolume grad) {
  __shared__ int64_t s_off[kWarpsPerBlock][siddon::kSlabAdds * kWarp];
  __shared__ float s_x[kWarpsPerBlock][siddon::kSlabAdds * kWarp];
  int64_t r = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kWarp;
  int lane = threadIdx.x % kWarp;
  int w = threadIdx.x / kWarp;
  if (r >= n_rays) return;  // the whole warp: r is the warp's
  siddon::Ray ray = siddon::load_ray(rows, n_rays, r);
  bool mip = arg != nullptr;
  int a = mip ? arg[r] : -1;
  float gr = g[r];
  if (gr == 0.f) return;  // every add is a product by g: none to make
  int lo, hi;
  siddon::scatter_range(ray, grad.X, a, mip, &lo, &hi);
  for (int base = lo; base < hi; base += kWarp) {
    int64_t off[siddon::kSlabAdds];
    float x[siddon::kSlabAdds];
    int s = base + lane;
    unsigned mask = s < hi ? siddon::slab_adds(ray, grad, s, gr, a, mip, off, x) : 0u;
    int total;
    int at = warp_offset<siddon::kSlabAdds>(mask, lane, &total);
#pragma unroll
    for (int j = 0; j < siddon::kSlabAdds; ++j) {
      if (mask >> j & 1u) {
        int q = at + __popc(mask & ((1u << j) - 1u));
        s_off[w][q] = off[j];
        s_x[w][q] = x[j];
      }
    }
    __syncwarp();
    for (int q = lane; q < total; q += kWarp) atomicAdd(grad.data + s_off[w][q], s_x[w][q]);
    __syncwarp();
  }
}

siddon::Volume make_volume(const float* vol, int64_t ss, int64_t sy, int64_t sz,
                           int X, int Y, int Z) {
  siddon::Volume v;
  v.data = vol;
  v.ss = ss;
  v.sy = sy;
  v.sz = sz;
  v.X = X;
  v.Y = Y;
  v.Z = Z;
  return v;
}

// Blocks of kThreads for n_threads threads.
unsigned int n_blocks(int64_t n_threads) {
  return (unsigned int)((n_threads + kThreads - 1) / kThreads);
}

// The entry points on a bricked copy of element type T, for march axis
// `axis` (-1 for an axis outside 0..2): launch(A, the copy's volume, the
// launch's blocks) launches the kernel.
template <class T, class Launch>
int on_copy(const T* vol, int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
            Launch launch) {
  return brick::with_axis(axis, [&](auto a) {
    constexpr int A = decltype(a)::value;
    launch(a, brick::make_volume<A>(vol, bs_s, bs_y, bs_z, X, Y, Z));
    return (int)cudaGetLastError();
  });
}

template <class T>
int fwd(const float* rows, int64_t n_rays, const T* vol, int axis, int bs_s, int bs_y,
        int bs_z, int X, int Y, int Z, float* out, void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto a, auto v) {
    if (n_rays > 0) {
      siddon_fwd_kernel<decltype(a)::value, T>
          <<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(rows, n_rays, v, out);
    }
  });
}

template <class T>
int fwdgrad(const float* rows, int64_t n_rays, const T* vol, int axis, int bs_s, int bs_y,
            int bs_z, int X, int Y, int Z, float* out, void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto a, auto v) {
    if (n_rays > 0) {
      siddon_fwdgrad_kernel<decltype(a)::value, T>
          <<<n_blocks(n_rays * siddon::kFusedLanes), kThreads, 0, (cudaStream_t)stream>>>(
              rows, n_rays, v, out);
    }
  });
}

template <class T>
int fwd_max(const float* rows, int64_t n_rays, const T* vol, int axis, int bs_s, int bs_y,
            int bs_z, int X, int Y, int Z, float* out, int* arg, void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto a, auto v) {
    if (n_rays > 0) {
      siddon_fwd_max_kernel<decltype(a)::value, T>
          <<<n_blocks(n_rays * siddon::kMaxLanes), kThreads, 0, (cudaStream_t)stream>>>(
              rows, n_rays, v, out, arg);
    }
  });
}

template <class T>
int bwd_rays(const float* rows, int64_t n_rays, const T* vol, int axis, int bs_s, int bs_y,
             int bs_z, int X, int Y, int Z, const float* g, float* out, void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto a, auto v) {
    if (n_rays > 0) {
      siddon_bwd_rays_kernel<decltype(a)::value, T>
          <<<n_blocks(n_rays * siddon::kBwdLanes), kThreads, 0, (cudaStream_t)stream>>>(
              rows, n_rays, v, g, out);
    }
  });
}

template <class Vol>
int bwd_rays_mip(const float* rows, int64_t n_rays, Vol vol, const float* g, const int* arg,
                 float* out, void* stream) {
  if (n_rays > 0) {
    siddon_bwd_rays_mip_kernel<Vol><<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, vol, g, arg, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). rows: (9, n_rays) float32; vol: the
// density's bricked copy (brick.cuh), axis the march axis, then the brick
// strides and the density's extents of the march-permuted (s, y, z) axes
// (siddon_bwd_rays_mip: the density itself, with the element strides
// (ss, sy, sz) and extents (X, Y, Z) of those axes); out: (n_rays,) for
// siddon_fwd, (10, n_rays) for siddon_fwdgrad, (n_rays,) values and
// (n_rays,) int32 codes for siddon_fwd_max, (9, n_rays) for siddon_bwd_rays
// (sum mode) and siddon_bwd_rays_mip; g: (n_rays,) float32; arg: (n_rays,)
// int32 argmax codes (MIP, or NULL for siddon_bwd_vol's sum mode); grad: a
// zero-filled float32 volume with the density's extents and its own strides
// (gs, gy, gz) in the same permuted order. Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError(); those that read the copy
// return -1 for an axis outside 0..2. The *_bf16 entry points take the
// same arguments with a bf16 bricked copy as vol; siddon_bwd_rays_mip_bf16
// takes siddon_bwd_rays' copy arguments (the bf16 copy) in place of the
// strided density's.
extern "C" int siddon_fwd(const float* rows, int64_t n_rays, const float* vol, int axis,
                          int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float* out,
                          void* stream) {
  return fwd(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, out, stream);
}

extern "C" int siddon_fwd_bf16(const float* rows, int64_t n_rays, const brick::bf16* vol,
                               int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                               float* out, void* stream) {
  return fwd(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, out, stream);
}

extern "C" int siddon_fwdgrad(const float* rows, int64_t n_rays, const float* vol, int axis,
                              int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float* out,
                              void* stream) {
  return fwdgrad(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, out, stream);
}

extern "C" int siddon_fwdgrad_bf16(const float* rows, int64_t n_rays, const brick::bf16* vol,
                                   int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                                   float* out, void* stream) {
  return fwdgrad(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, out, stream);
}

extern "C" int siddon_fwd_max(const float* rows, int64_t n_rays, const float* vol, int axis,
                              int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float* out,
                              int* arg, void* stream) {
  return fwd_max(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, out, arg, stream);
}

extern "C" int siddon_fwd_max_bf16(const float* rows, int64_t n_rays, const brick::bf16* vol,
                                   int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                                   float* out, int* arg, void* stream) {
  return fwd_max(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, out, arg, stream);
}

extern "C" int siddon_bwd_rays(const float* rows, int64_t n_rays, const float* vol, int axis,
                               int bs_s, int bs_y, int bs_z, int X, int Y, int Z, const float* g,
                               float* out, void* stream) {
  return bwd_rays(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, g, out, stream);
}

extern "C" int siddon_bwd_rays_bf16(const float* rows, int64_t n_rays, const brick::bf16* vol,
                                    int axis, int bs_s, int bs_y, int bs_z, int X, int Y, int Z,
                                    const float* g, float* out, void* stream) {
  return bwd_rays(rows, n_rays, vol, axis, bs_s, bs_y, bs_z, X, Y, Z, g, out, stream);
}

extern "C" int siddon_bwd_rays_mip(const float* rows, int64_t n_rays, const float* vol,
                                   int64_t ss, int64_t sy, int64_t sz, int X, int Y, int Z,
                                   const float* g, const int* arg, float* out, void* stream) {
  return bwd_rays_mip(rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z), g, arg, out, stream);
}

extern "C" int siddon_bwd_rays_mip_bf16(const float* rows, int64_t n_rays,
                                        const brick::bf16* vol, int axis, int bs_s, int bs_y,
                                        int bs_z, int X, int Y, int Z, const float* g,
                                        const int* arg, float* out, void* stream) {
  return on_copy(vol, axis, bs_s, bs_y, bs_z, X, Y, Z, [&](auto, auto v) {
    bwd_rays_mip(rows, n_rays, v, g, arg, out, stream);
  });
}

extern "C" int siddon_bwd_vol(const float* rows, int64_t n_rays, const float* g,
                              const int* arg, float* grad, int64_t gs, int64_t gy,
                              int64_t gz, int X, int Y, int Z, void* stream) {
  if (n_rays > 0) {
    siddon::GradVolume gv;
    gv.data = grad;
    gv.ss = gs;
    gv.sy = gy;
    gv.sz = gz;
    gv.X = X;
    gv.Y = Y;
    gv.Z = Z;
    siddon_bwd_vol_kernel<<<n_blocks(n_rays * kWarp), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, g, arg, gv);
  }
  return (int)cudaGetLastError();
}
