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
// Design: one thread per ray (the scatter aside, below), walking only its
// own slabs (slab_range in siddon.cuh) and reading the <= 3 voxels of each
// slab straight from the float32 volume through its strides. The TPU needed
// tile windows, a starts table, one-hot matmuls and a permuted, padded copy
// of the volume to turn these gathers into MXU work; on the H100 a gather is
// a load, so none of that is carried over. A MIP backward visits only the
// argmax slab.
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
#include <cuda_runtime.h>

#include "siddon.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;

// One thread per ray, reading the bricked copy with kFwdSlabs slabs' loads
// in flight (the note at the top of this file says why); A: the march axis.
template <int A>
__global__ void __launch_bounds__(kThreads)
siddon_fwd_kernel(const float* __restrict__ rows, int64_t n_rays, brick::Volume<A> vol,
                  float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  siddon::Ray ray = siddon::load_ray(rows, n_rays, r);
  out[r] = siddon::trace_fwd<siddon::kFwdSlabs>(ray, vol);
}

__global__ void __launch_bounds__(kThreads)
siddon_fwdgrad_kernel(const float* __restrict__ rows, int64_t n_rays, siddon::Volume vol,
                      float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  siddon::Ray ray = siddon::load_ray(rows, n_rays, r);
  float acc[siddon::kFusedRows];
  siddon::trace_fwdgrad(ray, vol, acc);
#pragma unroll
  for (int k = 0; k < siddon::kFusedRows; ++k) out[k * n_rays + r] = acc[k];
}

__global__ void __launch_bounds__(kThreads)
siddon_fwd_max_kernel(const float* __restrict__ rows, int64_t n_rays, siddon::Volume vol,
                      float* __restrict__ out, int* __restrict__ arg) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  siddon::Ray ray = siddon::load_ray(rows, n_rays, r);
  siddon::trace_fwd_max(ray, vol, out + r, arg + r);
}

// arg == nullptr: sum mode; else MIP, gated to arg[r].
__global__ void __launch_bounds__(kThreads)
siddon_bwd_rays_kernel(const float* __restrict__ rows, int64_t n_rays, siddon::Volume vol,
                       const float* __restrict__ g, const int* __restrict__ arg,
                       float* __restrict__ out) {
  int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  siddon::Ray ray = siddon::load_ray(rows, n_rays, r);
  float acc[siddon::kRows];
  siddon::trace_bwd_rays(ray, vol, g[r], arg ? arg[r] : -1, arg != nullptr, acc);
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

}  // namespace

// Plain C interface (loaded with ctypes). rows: (9, n_rays) float32; vol: the
// density with element strides (ss, sy, sz) of the march-permuted axes and
// extents (X, Y, Z); out: (n_rays,) for siddon_fwd, (10, n_rays) for
// siddon_fwdgrad, (n_rays,) values and (n_rays,) int32 codes for
// siddon_fwd_max, (9, n_rays) for siddon_bwd_rays; g: (n_rays,) float32;
// arg: (n_rays,) int32 argmax codes for MIP, or NULL for sum mode; grad: a
// zero-filled float32 volume with the density's extents and its own strides
// (gs, gy, gz) in the same permuted order. Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
//
// siddon_fwd reads the density's bricked copy (brick.cuh) instead: vol is
// the copy, axis the march axis, then the brick strides and the density's
// extents of the march-permuted (s, y, z) axes. It returns -1 for an axis
// outside 0..2.
template <int A>
int launch_fwd(const float* rows, int64_t n_rays, const float* vol, int bs_s, int bs_y, int bs_z,
               int X, int Y, int Z, float* out, void* stream) {
  if (n_rays > 0) {
    siddon_fwd_kernel<A><<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, brick::make_volume<A>(vol, bs_s, bs_y, bs_z, X, Y, Z), out);
  }
  return (int)cudaGetLastError();
}

extern "C" int siddon_fwd(const float* rows, int64_t n_rays, const float* vol, int axis,
                          int bs_s, int bs_y, int bs_z, int X, int Y, int Z, float* out,
                          void* stream) {
  switch (axis) {
    case 0: return launch_fwd<0>(rows, n_rays, vol, bs_s, bs_y, bs_z, X, Y, Z, out, stream);
    case 1: return launch_fwd<1>(rows, n_rays, vol, bs_s, bs_y, bs_z, X, Y, Z, out, stream);
    case 2: return launch_fwd<2>(rows, n_rays, vol, bs_s, bs_y, bs_z, X, Y, Z, out, stream);
    default: return -1;
  }
}

extern "C" int siddon_fwdgrad(const float* rows, int64_t n_rays, const float* vol,
                              int64_t ss, int64_t sy, int64_t sz, int X, int Y, int Z,
                              float* out, void* stream) {
  if (n_rays > 0) {
    siddon_fwdgrad_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z), out);
  }
  return (int)cudaGetLastError();
}

extern "C" int siddon_fwd_max(const float* rows, int64_t n_rays, const float* vol,
                              int64_t ss, int64_t sy, int64_t sz, int X, int Y, int Z,
                              float* out, int* arg, void* stream) {
  if (n_rays > 0) {
    siddon_fwd_max_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z), out, arg);
  }
  return (int)cudaGetLastError();
}

extern "C" int siddon_bwd_rays(const float* rows, int64_t n_rays, const float* vol,
                               int64_t ss, int64_t sy, int64_t sz, int X, int Y, int Z,
                               const float* g, const int* arg, float* out, void* stream) {
  if (n_rays > 0) {
    siddon_bwd_rays_kernel<<<n_blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_rays, make_volume(vol, ss, sy, sz, X, Y, Z), g, arg, out);
  }
  return (int)cudaGetLastError();
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
