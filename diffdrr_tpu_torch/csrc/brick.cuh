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
// one-thread-a-ray forwards keep their reads raw until the sums (siddon.cuh
// and joseph.cuh, trace_fwd on a bf16 copy): a read widened where it lands
// makes the thread wait on it there, so their batches of loads would not
// be in flight together.
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

}  // namespace brick
