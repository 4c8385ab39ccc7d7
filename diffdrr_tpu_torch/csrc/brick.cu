// The bricked copy of the density that the forwards, the fused pose kernels
// and the two-pass ray backwards' sum modes read (sm_90a). Layout glue, not
// a port of a TPU kernel: brick.cuh says what the copy is, fixes the brick
// shape and holds the copy's plan (which path, which element lands where),
// diffdrr_tpu_torch/ops/kernels/brick.py makes it.
//
// What bounds it: the bytes, one read and one write of the volume (139 MB
// each way for the 512x512x133 CT, 84 us at 3.35 TB/s). The copy's writes
// are one contiguous run a column of bricks (b0, b1); its reads are the
// column's 16 density rows. One kernel, one launch a copy: a block of 128
// threads takes a column over the whole of axis 2 (over 1024 voxels of it
// where axis 2 is longer: brick::kChunkZ), so no block is nearly empty
// whatever X2 is (blocks of 128 voxels of axis 2 left every other block of
// a 133-deep CT 5 voxels a row). It fills a tile of shared memory with the
// column's rows, 8 loads in flight a thread, and after one barrier writes
// the column's run in 16-byte stores, 4 floats or 8 bf16 each, reading the
// tile in brick order (brick::copy_source): 16-byte words where the chunk
// is a multiple of 4 voxels (the tile's pitch keeps a quarter warp's 8 rows
// in 8 bank groups), single words otherwise (rows then fall at most 2 to a
// bank). The zero padding comes from registers; it is never loaded.
//
// Two ways to fill the tile (brick::copy_packed picks; a template argument
// of the kernel):
// - packed rows (s2 = 1, s1 = X2, the data pointer and s0 16-byte aligned,
//   as in the DRR's contiguous density and its slabs): a column's rows of
//   one plane are one contiguous span, 16-byte aligned even where the
//   133-voxel rows are not, read in 16-byte loads (brick::span_target; span
//   tails of fewer than 4 elements a word at a time). On the H100 this runs
//   as fast as torch.Tensor.clone() of the density, which moves the same
//   bytes; loading the same rows an element at a time is 19% slower in
//   float32 and 38% in bf16 at the main CT (PERF.md);
// - any other strides (a permuted density, a slab narrowed along axis 2, a
//   pointer or s0 off 16 bytes): each element loaded through the strides,
//   consecutive threads along axis 2 where its stride is the smallest, else
//   along the column's rows (brick::Walk), so that a warp's loads share
//   lines in either layout.
//
// Under storage="bf16" the same kernel writes a bf16 copy (brick_copy_bf16):
// each voxel rounded to the nearest bf16, ties to even (brick::to_bf16, the
// rounding of torch.Tensor.to(torch.bfloat16) on the card), as the voxels
// leave shared memory. Its writes are half the float32 copy's; its reads
// are the same float32 density. A labelmap's int32 bits (the float32 copy)
// move untouched: loads, stores and selects, no float arithmetic.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "brick.cuh"

namespace {

using brick::CopyPlan;
using brick::kColumnRows;
using brick::kCopyThreads;
using brick::kL0;
using brick::kL1;
using brick::kL2;

constexpr int kLv = kL0 + kL1 + kL2;  // log2 of a brick's elements
// At most 64 tile rows; 4 consecutive elements of a brick share a row (the
// 16-byte stores and tile reads); a chunk of whole bricks.
static_assert(kL0 + kL1 <= 6 && kL2 <= 7, "brick shape too large for brick_copy's tile");
static_assert(kL2 >= 2, "brick_copy's 16-byte stores need 4 voxels a brick row");
static_assert(brick::kChunkZ % (1 << kL2) == 0, "a chunk of axis 2 must be whole bricks");

constexpr int kBatch = 8;  // loads in flight a thread

// A voxel as the copy of element type T stores it.
__device__ __forceinline__ float store_as(float x, float*) { return x; }
__device__ __forceinline__ brick::bf16 store_as(float x, brick::bf16*) {
  return brick::to_bf16(x);
}

// Tile word i, or 0 for the padding (i < 0).
__device__ __forceinline__ float tile_at(const float* tile, int i) {
  return i >= 0 ? tile[i] : 0.f;
}

// 4 elements of a chunk's bricks from element o on (o a multiple of 4: one
// brick row), as float32; `len` the chunk's voxels of axis 2.
__device__ __forceinline__ float4 run4(const float* tile, const CopyPlan& p, int b0, int b1,
                                       int len, int o) {
  if (len % 4 == 0) {  // the 4 voxels lie inside or outside together, 16 bytes aligned
    int i = brick::copy_source(p, b0, b1, len, o);
    return i >= 0 ? *reinterpret_cast<const float4*>(tile + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return make_float4(tile_at(tile, brick::copy_source(p, b0, b1, len, o)),
                     tile_at(tile, brick::copy_source(p, b0, b1, len, o + 1)),
                     tile_at(tile, brick::copy_source(p, b0, b1, len, o + 2)),
                     tile_at(tile, brick::copy_source(p, b0, b1, len, o + 3)));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)brick::to_bf16(lo) | ((uint32_t)brick::to_bf16(hi) << 16);
}

// A chunk's bricks, by a block of kThreads: 16-byte stores of 4 floats ...
template <int kThreads>
__device__ __forceinline__ void write_run(const float* tile, const CopyPlan& p, int b0, int b1,
                                          int len, float* out) {
  float4* out4 = reinterpret_cast<float4*>(out);
  int n = ((len + (1 << kL2) - 1) >> kL2) << (kLv - 2);
  for (int q = threadIdx.x; q < n; q += kThreads) out4[q] = run4(tile, p, b0, b1, len, q << 2);
}

// ... or of 8 bf16 (two brick rows), each rounded as it leaves the tile.
template <int kThreads>
__device__ __forceinline__ void write_run(const float* tile, const CopyPlan& p, int b0, int b1,
                                          int len, brick::bf16* out) {
  uint4* out4 = reinterpret_cast<uint4*>(out);
  int n = ((len + (1 << kL2) - 1) >> kL2) << (kLv - 3);
  for (int q = threadIdx.x; q < n; q += kThreads) {
    float4 a = run4(tile, p, b0, b1, len, q << 3),
           b = run4(tile, p, b0, b1, len, (q << 3) + 4);
    out4[q] = make_uint4(bf16_pair(a.x, a.y), bf16_pair(a.z, a.w), bf16_pair(b.x, b.y),
                         bf16_pair(b.z, b.w));
  }
}

// The packed path: column (b0, b1)'s spans into the tile, by a block of
// kThreads: each thread's kB 16-byte loads in flight before it stores any;
// then the spans' tails a word at a time.
template <int kThreads, int kB>
__device__ __forceinline__ void read_spans(const float* __restrict__ src, const CopyPlan& p,
                                           int b0, int b1, float* tile) {
  // Every span of the column has the same length but those past X0 (0).
  int len = brick::span_length(p, b0, b1, 0);
  int nv = len >> 2;  // its 16-byte words
  int spans = min(1 << kL0, p.X0 - (b0 << kL0));
  int total = spans * nv;
  for (int q0 = 0; q0 < total; q0 += kB * kThreads) {
    float4 v[kB];
    int at[kB];
#pragma unroll
    for (int m = 0; m < kB; ++m) {
      int q = q0 + m * kThreads + threadIdx.x;
      at[m] = -1;
      if (q < total) {
        int e0 = 0;
#pragma unroll
        for (int s = 1; s < (1 << kL0); ++s) e0 += q >= s * nv;
        int j = (q - e0 * nv) << 2;
        v[m] = __ldg(reinterpret_cast<const float4*>(src + brick::span_offset(p, b0, b1, e0) + j));
        at[m] = brick::span_target(p, e0, j);
      }
    }
#pragma unroll
    for (int m = 0; m < kB; ++m)
      if (at[m] >= 0) *reinterpret_cast<float4*>(tile + at[m]) = v[m];
  }
  int tail = len & 3;  // a span's last elements short of a 16-byte word
  for (int t = threadIdx.x; t < spans * tail; t += kThreads) {
    int e0 = t / tail, j = (nv << 2) + t % tail;
    tile[brick::span_target(p, e0, j)] = __ldg(src + brick::span_offset(p, b0, b1, e0) + j);
  }
}

// Any strides: chunk c (`len` voxels of axis 2) of column (b0, b1) into the
// tile an element at a time along each thread's walk, kB loads in flight.
template <int kThreads, int kB>
__device__ __forceinline__ void read_elements(const float* __restrict__ src, const CopyPlan& p,
                                              int b0, int b1, int c, int len, float* tile) {
  brick::Walk w = brick::walk_start(p, len, threadIdx.x, kThreads);
  int z0 = c * p.chunk;
  for (int q0 = 0; q0 < kColumnRows * len; q0 += kB * kThreads) {
    float v[kB];
    int at[kB];
#pragma unroll
    for (int m = 0; m < kB; ++m) {
      int r, z;
      at[m] = -1;
      if (brick::walk_at(p, w, &r, &z) && brick::row_inside(p, b0, b1, r)) {
        v[m] = __ldg(src + brick::element_offset(p, b0, b1, r, z0 + z));
        at[m] = r * p.pitch + z;
      }
      brick::walk_next(w);
    }
#pragma unroll
    for (int m = 0; m < kB; ++m)
      if (at[m] >= 0) tile[at[m]] = v[m];
  }
}

// One block a chunk of a column: its rows into the tile, one barrier, its
// bricks out.
template <class T, bool kPacked, int kThreads = kCopyThreads, int kB = kBatch>
__global__ void __launch_bounds__(kThreads)
brick_copy_kernel(const float* __restrict__ src, CopyPlan p, T* __restrict__ dst) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  int c = blockIdx.x % p.chunks, col = blockIdx.x / p.chunks;
  int b1 = col % p.n1, b0 = col / p.n1;
  int len = brick::chunk_length(p, c);
  if (kPacked)
    read_spans<kThreads, kB>(src, p, b0, b1, tile);
  else
    read_elements<kThreads, kB>(src, p, b0, b1, c, len, tile);
  __syncthreads();
  write_run<kThreads>(tile, p, b0, b1, len, dst + brick::run_offset(p, b0, b1, c));
}

// A kernel's shared memory past the default 48 KB, where a tile needs it
// (a chunk past ~760 voxels); the error of that call, if any.
template <class K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <class T>
int copy(const float* src, int64_t s0, int64_t s1, int64_t s2, int X0, int X1, int X2, T* dst,
         void* stream) {
  CopyPlan p = brick::make_copy_plan((uint64_t)(uintptr_t)src, s0, s1, s2, X0, X1, X2);
  int64_t n_blocks = (int64_t)p.n0 * p.n1 * p.chunks;
  if (n_blocks == 0) return (int)cudaGetLastError();
  if (n_blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  size_t smem = (size_t)kColumnRows * p.pitch * sizeof(float);
  void (*kernel)(const float*, CopyPlan, T*) = brick_copy_kernel<T, false>;
  if (p.packed) kernel = brick_copy_kernel<T, true>;
  int rc = allow_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<(unsigned int)n_blocks, kCopyThreads, smem, (cudaStream_t)stream>>>(src, p, dst);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). src: the float32 density with
// element strides (s0, s1, s2) and extents (X0, X1, X2) in its own order;
// dst: the copy, (n0, n1, n2, 2^L0, 2^L1, 2^L2) contiguous with n_d =
// ceil(X_d / 2^L_d) and the L_d of brick.cuh, float32 (brick_copy) or bf16
// (brick_copy_bf16), 16-byte aligned. Launches one kernel on `stream`, its
// packed or its general instantiation (brick::copy_packed), does not
// synchronise, and returns cudaGetLastError().
extern "C" int brick_copy(const float* src, int64_t s0, int64_t s1, int64_t s2, int X0, int X1,
                          int X2, float* dst, void* stream) {
  return copy(src, s0, s1, s2, X0, X1, X2, dst, stream);
}

extern "C" int brick_copy_bf16(const float* src, int64_t s0, int64_t s1, int64_t s2, int X0,
                               int X1, int X2, brick::bf16* dst, void* stream) {
  return copy(src, s0, s1, s2, X0, X1, X2, dst, stream);
}

// Which path brick_copy takes for these arguments: 1 packed, 0 general
// (no launch).
extern "C" int brick_copy_packed_path(const float* src, int64_t s0, int64_t s1, int64_t s2,
                                      int X2) {
  return brick::copy_packed((uint64_t)(uintptr_t)src, s0, s1, s2, X2) ? 1 : 0;
}
