// The bricked copy's kernel before the one-block-a-column design, as a probe
// (sm_90a): what chip_smoke.py's phase 14 and fwd_timing.py's copy cases
// time the package's brick_copy against. It includes csrc/brick.cu, so the
// package's copy is called through the same library; the package never
// loads this file (built with -I diffdrr_tpu_torch/csrc, as fwd_timing.py's
// build_sources builds its probes).
//
// probe_brick_copy_parent(which, bf16, ...) takes brick_copy's arguments
// and runs, on `stream`, which 0: the parent's kernel (one block of 256
// threads a column of bricks over 128 voxels of axis 2, each element loaded
// on its own), 1: the package's brick_copy (brick_copy_bf16), its launch
// alone (no wrapper host work, no launch counter); bf16 0 the float32 copy,
// 1 the bf16 one. Returns cudaGetLastError().
#include "brick.cu"

namespace probe {

// The parent's kernel, as it was.
template <class T>
__global__ void __launch_bounds__(256)
parent_copy(const float* __restrict__ src, int64_t s0, int64_t s1, int64_t s2, int X0, int X1,
            int X2, int n1, int n2, int n_runs, T* __restrict__ dst) {
  constexpr int kRun = 128, kPitch = kRun + 1, kRows = 1 << (kL0 + kL1);
  __shared__ float tile[kRows * kPitch];
  int run = blockIdx.x % n_runs;
  int col = blockIdx.x / n_runs;
  int b1 = col % n1;
  int b0 = col / n1;
  int z0 = run * kRun;
#pragma unroll 8
  for (int k = threadIdx.x; k < kRows * kRun; k += 256) {
    int r = k / kRun, z = k % kRun;
    int i0 = (b0 << kL0) + (r >> kL1), i1 = (b1 << kL1) + (r & ((1 << kL1) - 1)), i2 = z0 + z;
    tile[r * kPitch + z] =
        (i0 < X0 && i1 < X1 && i2 < X2) ? __ldg(src + i0 * s0 + i1 * s1 + i2 * s2) : 0.f;
  }
  __syncthreads();
  int first = z0 >> kL2;
  int count = min(kRun >> kL2, n2 - first) << kLv;
  T* out = dst + ((((int64_t)b0 * n1 + b1) * n2 + first) << kLv);
  for (int o = threadIdx.x; o < count; o += 256) {
    int e = o & ((1 << kLv) - 1);
    int r = e >> kL2;
    int z = ((o >> kLv) << kL2) | (e & ((1 << kL2) - 1));
    out[o] = store_as(tile[r * kPitch + z], out);
  }
}

template <class T>
int parent(const float* src, int64_t s0, int64_t s1, int64_t s2, int X0, int X1, int X2, T* dst,
           cudaStream_t st) {
  int n0 = (X0 + (1 << kL0) - 1) >> kL0;
  int n1 = (X1 + (1 << kL1) - 1) >> kL1;
  int n2 = (X2 + (1 << kL2) - 1) >> kL2;
  int n_runs = ((n2 << kL2) + 127) / 128;
  int64_t n_blocks = (int64_t)n0 * n1 * n_runs;
  if (n_blocks > 0)
    parent_copy<T><<<(unsigned int)n_blocks, 256, 0, st>>>(src, s0, s1, s2, X0, X1, X2, n1, n2,
                                                           n_runs, dst);
  return (int)cudaGetLastError();
}

template <class T>
int parent_or_package(int which, const float* src, int64_t s0, int64_t s1, int64_t s2, int X0,
                      int X1, int X2, T* dst, cudaStream_t st) {
  if (which == 0) return parent(src, s0, s1, s2, X0, X1, X2, dst, st);
  return copy(src, s0, s1, s2, X0, X1, X2, dst, st);
}

}  // namespace probe

extern "C" int probe_brick_copy_parent(int which, int bf16, const float* src, int64_t s0,
                                       int64_t s1, int64_t s2, int X0, int X1, int X2,
                                       void* dst, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return probe::parent_or_package(which, src, s0, s1, s2, X0, X1, X2,
                                    static_cast<brick::bf16*>(dst), st);
  return probe::parent_or_package(which, src, s0, s1, s2, X0, X1, X2, static_cast<float*>(dst),
                                  st);
}
