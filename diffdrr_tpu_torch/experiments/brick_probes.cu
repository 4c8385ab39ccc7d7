// Probe kernels of diffdrr_tpu_torch/experiments/fwd_timing.py's copy cases
// (sm_90a): the bricked copy (csrc/brick.cu) as the kernel before the
// one-block-a-column design (brick_parent.cu), and variants of the
// package's kernel, to see what bounds the copy. fwd_timing.py compiles
// this file with the package's nvcc flags and -I diffdrr_tpu_torch/csrc;
// through brick_parent.cu it includes brick.cu, so the package's kernel and
// its helpers are the ones the variants reuse. The package never loads it.
//
// probe_brick_copy(variant, bf16, ...) takes brick_copy's arguments and
//   variant 0  the parent: one block of 256 threads a column of bricks over
//              128 voxels of axis 2, each element loaded on its own;
//           1  the package's kernel on the packed path (128 threads, 8
//              16-byte loads in flight a thread);
//           2  packed, 256 threads, 4 loads in flight;
//           3  packed, 128 threads, 4 loads in flight;
//           4  packed, 64 threads, 8 loads in flight;
//           5  the spans into shared memory by cp.async.bulk (one thread
//              issues a bulk copy a span, or a row where the tile's rows are
//              padded; an mbarrier counts the bytes), one block a column;
//           6  as 5 in a persistent block of 128 threads, two tiles: the next
//              column's bulk copies in flight while the block writes this
//              one's run (a grid of 4 blocks an SM);
//           7  the packed path's reads alone (spans into the tile, no run
//              written);
//           8  the packed path's writes alone (the run from a tile never
//              filled);
//           9  the package's brick_copy itself (either path), without the
//              wrapper's host work;
//          10  the package's kernel on the general path whatever the
//              strides (each element loaded on its own), consecutive
//              threads along axis 2, 128 threads, 8 loads in flight;
//          11  as 10, 256 threads;
//          12  as 10, 16 loads in flight;
//          13  as 10, consecutive threads along the column's 16 rows;
//   bf16   0 the float32 copy, 1 the bf16 copy.
// Variants 1-8 need the packed path (brick::copy_packed) and return -1
// where it does not apply, 10-13 an axis 2 of at most brick::kChunkZ; each
// returns cudaGetLastError(). An mbarrier wait that has not completed after
// 2^20 tries traps (a kernel error, not a hang).
#include "brick_parent.cu"

namespace probe {

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  for (int tries = 0; tries < (1 << 20); ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

__device__ __forceinline__ void bulk(float* dst, const float* src, uint32_t bytes,
                                     uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// Thread 0: column (b0, b1)'s spans (their 16-byte words; rows of X2 words
// apiece where the tile's rows are padded) by bulk copies counted on `bar`.
__device__ __forceinline__ void issue_spans(const float* src, const CopyPlan& p, int b0, int b1,
                                            float* tile, uint64_t* bar) {
  int len = brick::span_length(p, b0, b1, 0);
  int spans = min(1 << kL0, p.X0 - (b0 << kL0));
  int words = (len >> 2) << 2;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  bar_expect(bar, (uint32_t)(spans * words * 4));
  for (int e0 = 0; e0 < spans; ++e0) {
    const float* span = src + brick::span_offset(p, b0, b1, e0);
    if (p.pitch == p.X2) {
      if (words) bulk(tile + brick::span_target(p, e0, 0), span, words * 4, bar);
    } else {
      for (int j = 0; j < len; j += p.X2)
        bulk(tile + brick::span_target(p, e0, j), span + j, p.X2 * 4, bar);
    }
  }
}

// Every thread: the spans' tails (the elements past their 16-byte words).
__device__ __forceinline__ void tails(const float* src, const CopyPlan& p, int b0, int b1,
                                      float* tile, int n_threads) {
  int len = brick::span_length(p, b0, b1, 0);
  int tail = len & 3;
  int spans = min(1 << kL0, p.X0 - (b0 << kL0));
  for (int t = threadIdx.x; t < spans * tail; t += n_threads) {
    int e0 = t / tail, j = ((len >> 2) << 2) + t % tail;
    tile[brick::span_target(p, e0, j)] = __ldg(src + brick::span_offset(p, b0, b1, e0) + j);
  }
}

template <class T>
__global__ void __launch_bounds__(128)
bulk_copy(const float* __restrict__ src, CopyPlan p, T* __restrict__ dst) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  __shared__ uint64_t bar;
  int b1 = blockIdx.x % p.n1, b0 = blockIdx.x / p.n1;
  if (threadIdx.x == 0) bar_init(&bar);
  __syncthreads();
  if (threadIdx.x == 0) issue_spans(src, p, b0, b1, tile, &bar);
  tails(src, p, b0, b1, tile, 128);
  bar_wait(&bar, 0);
  __syncthreads();
  write_run<128>(tile, p, b0, b1, p.X2, dst + brick::run_offset(p, b0, b1, 0));
}

template <class T>
__global__ void __launch_bounds__(128)
bulk_copy_persistent(const float* __restrict__ src, CopyPlan p, T* __restrict__ dst) {
  extern __shared__ float4 tile4[];
  float* tiles[2] = {reinterpret_cast<float*>(tile4),
                     reinterpret_cast<float*>(tile4) + kColumnRows * p.pitch};
  __shared__ uint64_t bars[2];
  int cols = p.n0 * p.n1;
  if (threadIdx.x == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
  }
  __syncthreads();
  int col = blockIdx.x;
  if (threadIdx.x == 0 && col < cols)
    issue_spans(src, p, col / p.n1, col % p.n1, tiles[0], &bars[0]);
  for (int it = 0; col < cols; ++it, col += gridDim.x) {
    int next = col + gridDim.x, b = it & 1;
    if (threadIdx.x == 0 && next < cols)
      issue_spans(src, p, next / p.n1, next % p.n1, tiles[b ^ 1], &bars[b ^ 1]);
    int b0 = col / p.n1, b1 = col % p.n1;
    tails(src, p, b0, b1, tiles[b], 128);
    bar_wait(&bars[b], (it >> 1) & 1);
    __syncthreads();
    write_run<128>(tiles[b], p, b0, b1, p.X2, dst + brick::run_offset(p, b0, b1, 0));
    __syncthreads();
  }
}

template <class T>
__global__ void __launch_bounds__(128)
reads_only(const float* __restrict__ src, CopyPlan p, T* __restrict__ dst) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  int b1 = blockIdx.x % p.n1, b0 = blockIdx.x / p.n1;
  read_spans<128, 8>(src, p, b0, b1, tile);
  __syncthreads();
  // One word out a column, never taken, so the reads stay.
  if (tile[threadIdx.x] == 1.2345e-38f && p.X0 < 0) dst[blockIdx.x] = store_as(tile[0], dst);
}

template <class T>
__global__ void __launch_bounds__(128)
writes_only(const float* __restrict__ src, CopyPlan p, T* __restrict__ dst) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  int b1 = blockIdx.x % p.n1, b0 = blockIdx.x / p.n1;
  write_run<128>(tile, p, b0, b1, p.X2, dst + brick::run_offset(p, b0, b1, 0));
}

template <class T>
int run(int variant, const float* src, int64_t s0, int64_t s1, int64_t s2, int X0, int X1,
        int X2, T* dst, cudaStream_t st) {
  CopyPlan p = brick::make_copy_plan((uint64_t)(uintptr_t)src, s0, s1, s2, X0, X1, X2);
  unsigned int cols = (unsigned int)((int64_t)p.n0 * p.n1);
  if (cols == 0) return 0;
  if (variant == 9) return copy(src, s0, s1, s2, X0, X1, X2, dst, st);
  if (variant == 0) return parent(src, s0, s1, s2, X0, X1, X2, dst, st);
  size_t tile = (size_t)kColumnRows * p.pitch * sizeof(float);
  if (variant >= 10) {  // the general path, its order and shape as the variant says
    if (X2 > brick::kChunkZ) return -1;
    p.rows_first = variant == 13;
    auto launch = [&](auto kernel, int threads) {
      int rc = allow_smem(kernel, tile);
      if (rc == 0) kernel<<<cols, threads, tile, st>>>(src, p, dst);
      return rc != 0 ? rc : (int)cudaGetLastError();
    };
    switch (variant) {
      case 10: return launch(brick_copy_kernel<T, false, 128, 8>, 128);
      case 11: return launch(brick_copy_kernel<T, false, 256, 8>, 256);
      case 12: return launch(brick_copy_kernel<T, false, 128, 16>, 128);
      case 13: return launch(brick_copy_kernel<T, false, 128, 8>, 128);
      default: return -1;
    }
  }
  if (!p.packed) return -1;
  int rc;
  switch (variant) {
    case 1: rc = allow_smem(brick_copy_kernel<T, true>, tile);
      if (!rc) brick_copy_kernel<T, true><<<cols, 128, tile, st>>>(src, p, dst);
      break;
    case 2: rc = allow_smem(brick_copy_kernel<T, true, 256, 4>, tile);
      if (!rc) brick_copy_kernel<T, true, 256, 4><<<cols, 256, tile, st>>>(src, p, dst);
      break;
    case 3: rc = allow_smem(brick_copy_kernel<T, true, 128, 4>, tile);
      if (!rc) brick_copy_kernel<T, true, 128, 4><<<cols, 128, tile, st>>>(src, p, dst);
      break;
    case 4: rc = allow_smem(brick_copy_kernel<T, true, 64, 8>, tile);
      if (!rc) brick_copy_kernel<T, true, 64, 8><<<cols, 64, tile, st>>>(src, p, dst);
      break;
    case 5: rc = allow_smem(bulk_copy<T>, tile);
      if (!rc) bulk_copy<T><<<cols, 128, tile, st>>>(src, p, dst);
      break;
    case 6: {
      int sms = 0, dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      unsigned int grid = min(cols, (unsigned int)(4 * sms));
      rc = allow_smem(bulk_copy_persistent<T>, 2 * tile);
      if (!rc) bulk_copy_persistent<T><<<grid, 128, 2 * tile, st>>>(src, p, dst);
      break;
    }
    case 7: rc = allow_smem(reads_only<T>, tile);
      if (!rc) reads_only<T><<<cols, 128, tile, st>>>(src, p, dst);
      break;
    case 8: rc = allow_smem(writes_only<T>, tile);
      if (!rc) writes_only<T><<<cols, 128, tile, st>>>(src, p, dst);
      break;
    default: return -1;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace probe

extern "C" int probe_brick_copy(int variant, int bf16, const float* src, int64_t s0, int64_t s1,
                                int64_t s2, int X0, int X1, int X2, void* dst, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return probe::run(variant, src, s0, s1, s2, X0, X1, X2, static_cast<brick::bf16*>(dst), st);
  return probe::run(variant, src, s0, s1, s2, X0, X1, X2, static_cast<float*>(dst), st);
}
