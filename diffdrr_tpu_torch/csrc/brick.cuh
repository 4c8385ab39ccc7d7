// The bricked copy of the density that the forward gathers and the fused
// pose kernels read.
//
// Shared by siddon.cuh, joseph.cuh and brick.cu, and by any host build
// (BRICK_HD is empty without nvcc). The copy
// (diffdrr_tpu_torch/ops/kernels/brick.py) keeps the density's own
// (X, Y, Z) index order, cut into bricks of 2^L0 x 2^L1 x 2^L2 voxels, each
// brick contiguous (row-major inside) and the bricks in row-major order;
// the extents are padded with zeros to whole bricks. So a voxel index i
// along density axis d lands at
//
//     (i >> L_d) * brick_stride_d + (i & (2^L_d - 1)) * elem_stride_d
//
// and the three axes' offsets add. The brick shape is a compile-time
// constant: the shifts, masks and element strides fold into the code, and
// only the brick strides (which depend on the extents) come at run time.
// A march reads the copy in its march-permuted (s, y, z) order, s being
// density axis A, so the volume is a template on A and one copy serves
// every march axis. A brick of 64 floats is two 128-byte lines: the voxels
// a warp's rays read at one slab (neighbouring detector pixels, ~1-1.5
// voxels apart) fall in a few lines instead of one line per ray.
//
// The copy's element is float32, or bf16 under storage="bf16" (the JAX
// package's bf16 density storage): the volume is a template on its element
// type T, float or bf16 (the 16 bits of a bfloat16). A read is two steps:
// load_raw() fetches the element as it is stored, and widen() turns it into
// float32, exactly (the identity for a float). load() is the two at once.
// A kernel's arithmetic after the widening is the same for both types, so
// a bf16 copy gives, bit for bit, what the float32 copy of the density
// rounded to bf16 gives. The rounding happens once, in the copy (to_bf16
// below, which brick.cu applies: round to nearest, ties to even). The two
// one-thread-a-ray forwards keep their reads raw until the sums, and the
// fused pose kernels (with the two-pass sum backwards) until the rows
// (siddon.cuh and joseph.cuh: trace_fwd and fused_terms on a bf16 copy): a
// read widened where it lands makes the thread wait on it there, so their
// batches of loads would not be in flight together.
#pragma once

#include <stdint.h>
#include <string.h>

#include <type_traits>

#if defined(__CUDACC__)
#include <cuda_bf16.h>
#define BRICK_HD __host__ __device__ __forceinline__
#else
#define BRICK_HD inline
#endif

// log2 of a brick's voxels along the density's axes 0, 1, 2: 4x4x4.
// ops/kernels/brick.py's BRICK is the same shape. A build may give another
// with -DBRICK_L0=.. -DBRICK_L1=.. -DBRICK_L2=.. (the host-twin tests and
// the timing probes do); the package's kernels use this one.
#ifndef BRICK_L0
#define BRICK_L0 2
#endif
#ifndef BRICK_L1
#define BRICK_L1 2
#endif
#ifndef BRICK_L2
#define BRICK_L2 2
#endif

namespace brick {

// A bfloat16 as its 16 bits: the high half of the float32 it stands for.
using bf16 = uint16_t;

constexpr int kL0 = BRICK_L0, kL1 = BRICK_L1, kL2 = BRICK_L2;
constexpr int kVoxels = 1 << (kL0 + kL1 + kL2);  // elements of one brick

// Density axis D of the copy: its shift and its element stride in a brick.
template <int D>
struct Axis {
  static constexpr int shift = D == 0 ? kL0 : D == 1 ? kL1 : kL2;
  static constexpr int elem = D == 0 ? 1 << (kL1 + kL2) : D == 1 ? 1 << kL2 : 1;
};

// The copy as march axis A sees it, its elements of type T (float or
// bf16). The brick strides are 32-bit (the wrapper checks that they fit),
// so each product is one 32 x 32 -> 64-bit multiply; the last density
// axis's is kVoxels whatever the extents.
template <int A, class T = float>
struct Volume {
  static constexpr int kS = A;                // density axis of s
  static constexpr int kY = A == 0 ? 1 : 0;   // of y
  static constexpr int kZ = A == 2 ? 1 : 2;   // of z
  const T* data;
  int bs_s, bs_y, bs_z;  // brick strides of the (s, y, z) axes
  int X, Y, Z;           // the density's extents along them (not the padded ones)
};

// Element offset of voxel index i (>= 0) along density axis D.
template <int D>
BRICK_HD int64_t offset(int i, int brick_stride) {
  int bs = D == 2 ? kVoxels : brick_stride;
  int mask = (1 << Axis<D>::shift) - 1;
  return (int64_t)(i >> Axis<D>::shift) * bs + (i & mask) * Axis<D>::elem;
}

template <int A, class T>
BRICK_HD int64_t offset(const Volume<A, T>& v, int s, int y, int z) {
  return offset<Volume<A, T>::kS>(s, v.bs_s) + offset<Volume<A, T>::kY>(y, v.bs_y) +
         offset<Volume<A, T>::kZ>(z, v.bs_z);
}

// The volume of a C entry point's arguments: the (s, y, z) axes' brick
// strides, then their extents.
template <int A, class T>
BRICK_HD Volume<A, T> make_volume(const T* data, int bs_s, int bs_y, int bs_z, int X, int Y,
                                  int Z) {
  Volume<A, T> v;
  v.data = data;
  v.bs_s = bs_s;
  v.bs_y = bs_y;
  v.bs_z = bs_z;
  v.X = X;
  v.Y = Y;
  v.Z = Z;
  return v;
}

// f(std::integral_constant<int, A>()) for march axis A = axis, as an int
// (a C entry point's return code); -1 for an axis outside 0..2.
template <class F>
inline int with_axis(int axis, F f) {
  switch (axis) {
    case 0: return f(std::integral_constant<int, 0>());
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    default: return -1;
  }
}

// One read of the read-only copy, the element as it is stored: the
// non-coherent load path on the device.
BRICK_HD float load_raw(const float* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

BRICK_HD bf16 load_raw(const bf16* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(reinterpret_cast<const unsigned short*>(p));
#else
  return *p;
#endif
}

// float32 of a bf16's bits: the bits shifted into the high half, exact.
BRICK_HD float from_bf16(uint32_t bits) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(bits << 16);
#else
  uint32_t u = bits << 16;
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
#endif
}

// A raw element as float32, exactly: the identity for a float, from_bf16
// for a bf16 (its zero bits give +0.0).
BRICK_HD float widen(float x) { return x; }

BRICK_HD float widen(bf16 x) { return from_bf16(x); }

// One read of the copy, widened to float32 where it lands.
template <class T>
BRICK_HD float load(const T* p) {
  return widen(load_raw(p));
}

// x rounded to the nearest bf16, ties to even: __float2bfloat16_rn on the
// device, which is what torch.Tensor.to(torch.bfloat16) runs on a CUDA
// tensor (a NaN becomes the canonical NaN 0x7fff, a finite value past the
// largest bf16 an infinity, a subnormal keeps its rounded bits); the same
// rounding by integer arithmetic on the host.
BRICK_HD bf16 to_bf16(float x) {
#if defined(__CUDA_ARCH__)
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
#else
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fff;  // NaN
  return (bf16)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
#endif
}

// ---------------------------------------------------------------------------
// The copy's plan (brick.cu's brick_copy and brick_copy_bf16; the host twin
// in tests/test_torch_kernel_twin.py runs the same functions).
//
// A column of bricks (b0, b1) is the copy's contiguous run of n2 bricks
// along axis 2. It holds the 2^L0 x 2^L1 density rows (i0, i1) with
// i0 >> L0 = b0 and i1 >> L1 = b1, numbered r = (e0 << L1) | e1 by their
// place (e0, e1) in a brick. A block copies one column over a chunk of up
// to kChunkZ voxels of axis 2 (the whole axis but for longer ones): it
// fills a tile of shared memory, row r at tile word r * pitch, then writes
// the chunk's bricks, one contiguous stretch of the column's run, from the
// tile in the copy's order (copy_source). It fills the tile in one of two
// ways. Where the density's rows are packed (s2 = 1, s1 = X2, as in a
// contiguous density), the rows of one plane i0 in a column are one
// contiguous span of the density, of up to 2^L1 X2 elements, starting
// 4 (i0 s0 + (b1 << L1) X2) bytes from the data pointer: 16-byte aligned
// whenever the pointer is and s0 is a multiple of 4, whatever X2 is. The
// packed path reads each span whole, in 16-byte loads (span_*). Any other
// density is read an element at a time through its strides, the block's
// threads walking the chunk's elements (Walk) with consecutive threads
// along axis 2 where its stride is the smallest, else along the column's
// rows.
// ---------------------------------------------------------------------------

// The longest stretch of axis 2 a block copies: a column's tile of
// 2^(L0 + L1) rows then fills at most 64 KiB of shared memory (16 x 1028
// words). A multiple of 2^L2, so that every chunk but the last is whole
// bricks.
constexpr int kChunkZ = 1024;
// The threads of a block (brick.cu); the walks of the general path take
// this many elements a step.
constexpr int kCopyThreads = 128;

// A copy's geometry: the density's element strides and extents, the copy's
// bricks along each axis, the voxels of axis 2 a block copies and the
// blocks a column, the tile's words a row, and how the tile is filled.
struct CopyPlan {
  int64_t s0, s1, s2;
  int X0, X1, X2;
  int n0, n1, n2;
  int chunk, chunks;
  int pitch;
  bool packed;      // rows read as whole spans (copy_packed)
  bool rows_first;  // else: consecutive threads along the column's rows
};

// Whether the packed path copies a density at byte address `src` with
// these strides and extents: its rows packed, every span 16-byte aligned,
// and axis 2 one chunk.
BRICK_HD bool copy_packed(uint64_t src, int64_t s0, int64_t s1, int64_t s2, int X2) {
  return s2 == 1 && s1 == X2 && s0 % 4 == 0 && src % 16 == 0 && X2 <= kChunkZ;
}

// The tile's pitch for chunks of `chunk` voxels: `chunk` words, so that a
// span lands whole, its rows one after another; chunk + 4 where chunk is a
// multiple of 8, so that the 8 rows a quarter warp reads in 16-byte words
// at one z start in 8 different bank groups (a pitch of 4 x an odd number
// of words). Where a chunk is not a multiple of 4 the tile is read a word
// at a time: rows `chunk` words apart then fall at most 2 to a bank.
BRICK_HD int copy_pitch(int chunk) { return chunk % 8 == 0 ? chunk + 4 : chunk; }

BRICK_HD CopyPlan make_copy_plan(uint64_t src, int64_t s0, int64_t s1, int64_t s2, int X0,
                                 int X1, int X2) {
  CopyPlan p;
  p.s0 = s0;
  p.s1 = s1;
  p.s2 = s2;
  p.X0 = X0;
  p.X1 = X1;
  p.X2 = X2;
  p.n0 = (X0 + (1 << kL0) - 1) >> kL0;
  p.n1 = (X1 + (1 << kL1) - 1) >> kL1;
  p.n2 = (X2 + (1 << kL2) - 1) >> kL2;
  p.chunk = X2 < kChunkZ ? X2 : kChunkZ;
  p.chunks = p.chunk > 0 ? (X2 + p.chunk - 1) / p.chunk : 0;
  p.pitch = copy_pitch(p.chunk);
  p.packed = copy_packed(src, s0, s1, s2, X2);
  p.rows_first = !(s2 <= s0 && s2 <= s1);
  return p;
}

// The rows of a column: its tile's rows.
constexpr int kColumnRows = 1 << (kL0 + kL1);

// Whether row r of column (b0, b1) lies inside the density.
BRICK_HD bool row_inside(const CopyPlan& p, int b0, int b1, int r) {
  return (b0 << kL0) + (r >> kL1) < p.X0 && (b1 << kL1) + (r & ((1 << kL1) - 1)) < p.X1;
}

// The voxels of axis 2 in chunk c, from c x chunk on.
BRICK_HD int chunk_length(const CopyPlan& p, int c) {
  int rest = p.X2 - c * p.chunk;
  return rest < p.chunk ? rest : p.chunk;
}

// Span e0 of column (b0, b1) on the packed path (one chunk): the element
// offset of its first voxel from the data pointer, and its length in
// elements (0 where plane (b0 << L0) + e0 lies past X0; fewer than 2^L1 rows
// in the last column along axis 1 when X1 is not a multiple of 2^L1).
BRICK_HD int64_t span_offset(const CopyPlan& p, int b0, int b1, int e0) {
  return (int64_t)((b0 << kL0) + e0) * p.s0 + (int64_t)(b1 << kL1) * p.X2;
}

BRICK_HD int span_length(const CopyPlan& p, int b0, int b1, int e0) {
  if ((b0 << kL0) + e0 >= p.X0) return 0;
  int rows = p.X1 - (b1 << kL1);
  return (rows < (1 << kL1) ? rows : (1 << kL1)) * p.X2;
}

// The tile word that element j of span e0 lands at (its row j / X2, by
// comparisons: no division).
BRICK_HD int span_target(const CopyPlan& p, int e0, int j) {
  int row = 0;
  for (int s = 1; s < (1 << kL1); ++s) row += j >= s * p.X2;
  return (e0 << kL1) * p.pitch + j + (p.pitch - p.X2) * row;
}

// The general path's walk: thread t of a block's n takes elements t, t + n,
// t + 2n, ... of a chunk's 2^(L0 + L1) x len, numbered along the fast
// index f (of extent F: the chunk's voxels of axis 2, or the rows where
// rows_first) and then the slow one s; a step adds n to the number.
struct Walk {
  int f, s, F, S, df, ds;
};

BRICK_HD Walk walk_start(const CopyPlan& p, int len, int t, int n) {
  Walk w;
  w.F = p.rows_first ? kColumnRows : len;
  w.S = p.rows_first ? len : kColumnRows;
  w.f = t % w.F;
  w.s = t / w.F;
  w.df = n % w.F;
  w.ds = n / w.F;
  return w;
}

// Whether the walk is still inside the chunk; its row and its voxel of the
// chunk along axis 2.
BRICK_HD bool walk_at(const CopyPlan& p, const Walk& w, int* r, int* z) {
  *r = p.rows_first ? w.f : w.s;
  *z = p.rows_first ? w.s : w.f;
  return w.s < w.S;
}

BRICK_HD void walk_next(Walk& w) {
  w.f += w.df;
  w.s += w.ds;
  if (w.f >= w.F) {
    w.f -= w.F;
    ++w.s;
  }
}

// The element offset from the data pointer of row r of column (b0, b1) at
// voxel z of axis 2.
BRICK_HD int64_t element_offset(const CopyPlan& p, int b0, int b1, int r, int z) {
  return (int64_t)((b0 << kL0) + (r >> kL1)) * p.s0 +
         (int64_t)((b1 << kL1) + (r & ((1 << kL1) - 1))) * p.s1 + (int64_t)z * p.s2;
}

// The tile word that element o of a chunk's bricks (0 <= o < its bricks
// x 2^(L0 + L1 + L2)) comes from, `len` the chunk's voxels of axis 2, or -1
// for the zero padding.
BRICK_HD int copy_source(const CopyPlan& p, int b0, int b1, int len, int o) {
  int e = o & (kVoxels - 1);
  int r = e >> kL2;
  int z = ((o >> (kL0 + kL1 + kL2)) << kL2) | (e & ((1 << kL2) - 1));
  return row_inside(p, b0, b1, r) && z < len ? r * p.pitch + z : -1;
}

// The element offset in the copy of chunk c of column (b0, b1): the
// column's run, then c x chunk voxels of axis 2 on (whole bricks).
BRICK_HD int64_t run_offset(const CopyPlan& p, int b0, int b1, int c) {
  return ((((int64_t)b0 * p.n1 + b1) * p.n2) << (kL0 + kL1 + kL2)) +
         ((int64_t)c * p.chunk << (kL0 + kL1));
}

}  // namespace brick
