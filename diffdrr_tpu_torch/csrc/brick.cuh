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
#pragma once

#include <stdint.h>

#include <type_traits>

#if defined(__CUDACC__)
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

constexpr int kL0 = BRICK_L0, kL1 = BRICK_L1, kL2 = BRICK_L2;
constexpr int kVoxels = 1 << (kL0 + kL1 + kL2);  // elements of one brick

// Density axis D of the copy: its shift and its element stride in a brick.
template <int D>
struct Axis {
  static constexpr int shift = D == 0 ? kL0 : D == 1 ? kL1 : kL2;
  static constexpr int elem = D == 0 ? 1 << (kL1 + kL2) : D == 1 ? 1 << kL2 : 1;
};

// The copy as march axis A sees it. The brick strides are 32-bit (the
// wrapper checks that they fit), so each product is one 32 x 32 -> 64-bit
// multiply; the last density axis's is kVoxels whatever the extents.
template <int A>
struct Volume {
  static constexpr int kS = A;                // density axis of s
  static constexpr int kY = A == 0 ? 1 : 0;   // of y
  static constexpr int kZ = A == 2 ? 1 : 2;   // of z
  const float* data;
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

template <int A>
BRICK_HD int64_t offset(const Volume<A>& v, int s, int y, int z) {
  return offset<Volume<A>::kS>(s, v.bs_s) + offset<Volume<A>::kY>(y, v.bs_y) +
         offset<Volume<A>::kZ>(z, v.bs_z);
}

// The volume of a C entry point's arguments: the (s, y, z) axes' brick
// strides, then their extents.
template <int A>
BRICK_HD Volume<A> make_volume(const float* data, int bs_s, int bs_y, int bs_z, int X, int Y,
                               int Z) {
  Volume<A> v;
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

// One read of the read-only copy: the non-coherent load path on the device.
BRICK_HD float load(const float* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

}  // namespace brick
