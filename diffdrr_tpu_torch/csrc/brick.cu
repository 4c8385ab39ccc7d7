// The bricked copy of the density that siddon_fwd and joseph_fwd read
// (sm_90a). Layout glue, not a port of a TPU kernel: brick.cuh says what
// the copy is and fixes the brick shape, diffdrr_tpu_torch/ops/kernels/
// brick.py makes it.
//
// What bounds it: the bytes, one read and one write of the volume (139 MB
// each way for the 512x512x133 CT, 83 us at 3.35 TB/s). A copy that maps
// one thread to each element of the copy writes coalesced but gathers its
// reads, 2 floats from each of 16 rows a warp (0.21-0.23 ms for that CT).
// Here a block takes one column of bricks, the B0 x B1 rows of
// the density that the bricks (b0, b1, .) hold, over 128 voxels of axis 2:
// it reads those rows' 128-voxel runs coalesced into shared memory, several
// loads in flight a thread, then writes the 128 / B2 bricks they fill, one
// contiguous run of the copy. Voxels outside the density's extents are
// written as 0. It takes 0.15 ms for the 512x512x128 CT but still 0.22-0.24
// ms for the 512x512x133 one, whose 133-voxel rows are neither aligned nor
// whole runs (PERF.md): tuning it is later work.
//
// Under storage="bf16" the same kernel writes a bf16 copy (brick_copy_bf16):
// each voxel rounded to the nearest bf16, ties to even (brick::to_bf16, the
// rounding of torch.Tensor.to(torch.bfloat16) on the card), as the voxels
// leave shared memory. Its writes are half the float32 copy's; its reads
// are the same float32 density.
#include <cuda_runtime.h>
#include <stdint.h>

#include "brick.cuh"

namespace {

using brick::kL0;
using brick::kL1;
using brick::kL2;

constexpr int kThreads = 256;
constexpr int kRun = 128;         // voxels of axis 2 a block copies
constexpr int kPitch = kRun + 1;  // a tile row in shared memory: +1, no bank conflicts
constexpr int kRows = 1 << (kL0 + kL1);  // the density rows a column of bricks holds
constexpr int kLv = kL0 + kL1 + kL2;     // log2 of a brick's elements
// At most 64 tile rows (33 KB of shared memory) and one brick a run.
static_assert(kL0 + kL1 <= 6 && kL2 <= 7, "brick shape too large for brick_copy's tile");

// A voxel as the copy of element type T stores it.
__device__ __forceinline__ float store_as(float x, float*) { return x; }
__device__ __forceinline__ brick::bf16 store_as(float x, brick::bf16*) {
  return brick::to_bf16(x);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
brick_copy_kernel(const float* __restrict__ src, int64_t s0, int64_t s1, int64_t s2, int X0,
                  int X1, int X2, int n1, int n2, int n_runs, T* __restrict__ dst) {
  __shared__ float tile[kRows * kPitch];
  int run = blockIdx.x % n_runs;
  int col = blockIdx.x / n_runs;
  int b1 = col % n1;
  int b0 = col / n1;
  int z0 = run * kRun;
#pragma unroll 8
  for (int k = threadIdx.x; k < kRows * kRun; k += kThreads) {
    int r = k / kRun, z = k % kRun;
    int i0 = (b0 << kL0) + (r >> kL1), i1 = (b1 << kL1) + (r & ((1 << kL1) - 1)), i2 = z0 + z;
    tile[r * kPitch + z] =
        (i0 < X0 && i1 < X1 && i2 < X2) ? __ldg(src + i0 * s0 + i1 * s1 + i2 * s2) : 0.f;
  }
  __syncthreads();
  int first = z0 >> kL2;                              // the run's first brick along axis 2
  int count = min(kRun >> kL2, n2 - first) << kLv;    // the elements of its bricks
  T* out = dst + ((((int64_t)b0 * n1 + b1) * n2 + first) << kLv);
  for (int o = threadIdx.x; o < count; o += kThreads) {
    int e = o & ((1 << kLv) - 1);
    int r = e >> kL2;  // (e0, e1) as a row of the tile
    int z = ((o >> kLv) << kL2) | (e & ((1 << kL2) - 1));
    out[o] = store_as(tile[r * kPitch + z], out);
  }
}

template <class T>
int copy(const float* src, int64_t s0, int64_t s1, int64_t s2, int X0, int X1, int X2, T* dst,
         void* stream) {
  int n0 = (X0 + (1 << kL0) - 1) >> kL0;
  int n1 = (X1 + (1 << kL1) - 1) >> kL1;
  int n2 = (X2 + (1 << kL2) - 1) >> kL2;
  int n_runs = ((n2 << kL2) + kRun - 1) / kRun;
  int64_t n_blocks = (int64_t)n0 * n1 * n_runs;
  if (n_blocks > 0) {
    brick_copy_kernel<T><<<(unsigned int)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        src, s0, s1, s2, X0, X1, X2, n1, n2, n_runs, dst);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). src: the float32 density with
// element strides (s0, s1, s2) and extents (X0, X1, X2) in its own order;
// dst: the copy, (n0, n1, n2, 2^L0, 2^L1, 2^L2) contiguous with n_d =
// ceil(X_d / 2^L_d) and the L_d of brick.cuh, float32 (brick_copy) or bf16
// (brick_copy_bf16). Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
extern "C" int brick_copy(const float* src, int64_t s0, int64_t s1, int64_t s2, int X0, int X1,
                          int X2, float* dst, void* stream) {
  return copy(src, s0, s1, s2, X0, X1, X2, dst, stream);
}

extern "C" int brick_copy_bf16(const float* src, int64_t s0, int64_t s1, int64_t s2, int X0,
                               int X1, int X2, brick::bf16* dst, void* stream) {
  return copy(src, s0, s1, s2, X0, X1, X2, dst, stream);
}
