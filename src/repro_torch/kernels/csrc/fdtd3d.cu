// One step of the 8th-order (radius 4) 3-D star stencil of FDTD3d, for
// Hopper (sm_90a):
//   out = c0 * x + sum_{r=1..4} c_r * (the 6 neighbours at distance r)
// over a grid whose faces repeat their edge values.
//
// Replaces the Pallas TPU kernel _fdtd_kernel in
// src/repro/kernels/fdtd3d/kernel.py, which reads an edge-padded copy of the
// grid in z slabs of 8 and needs Z % 8 == 0.
//
// Bound on the H100: device memory.  A step reads the grid once and writes it
// once, 8 bytes per cell, against 29 fp32 operations: 3.6 flop per byte,
// below the card's 20 flop/byte fp32 ridge.
// Design: the kernel takes the unpadded grid and clamps each neighbour index
// to [0, dim - 1], which is exactly edge padding; so no padded copy is
// written and read, which at the paper's 1.7 G cells would be ~14 GB of
// traffic per step on top of the step's own 13.7 GB.  A block owns a 32 x 8
// tile of (x, y) columns and walks it down z; each thread keeps its column's
// 9 values z-4 .. z+4 in registers, so a z neighbour is read from device
// memory once per step, and only the 16 x-y neighbours come from L1/L2.
// Offsets are 64-bit: a grid may hold more than 2^31 cells.  A shared-memory
// x-y tile, as in the CUDA FDTD3d sample, is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kR = 4;
constexpr int kTX = 32, kTY = 8;

__global__ void __launch_bounds__(kTX * kTY)
    fdtd3d_kernel(const float* __restrict__ in,
                  const float* __restrict__ coeffs, float* __restrict__ out,
                  int64_t Z, int64_t Y, int64_t X) {
  const int64_t x = static_cast<int64_t>(blockIdx.x) * kTX + threadIdx.x;
  const int64_t y = static_cast<int64_t>(blockIdx.y) * kTY + threadIdx.y;
  if (x >= X || y >= Y) return;

  float c[kR + 1];
#pragma unroll
  for (int r = 0; r <= kR; ++r) c[r] = __ldg(coeffs + r);

  // In-plane neighbour offsets, clamped to the grid's edge.
  int64_t ym[kR], yp[kR], xm[kR], xp[kR];
#pragma unroll
  for (int r = 1; r <= kR; ++r) {
    ym[r - 1] = ((y - r > 0 ? y - r : 0) - y) * X;
    yp[r - 1] = ((y + r < Y - 1 ? y + r : Y - 1) - y) * X;
    xm[r - 1] = (x - r > 0 ? x - r : 0) - x;
    xp[r - 1] = (x + r < X - 1 ? x + r : X - 1) - x;
  }

  const int64_t plane = Y * X;
  const float* col = in + y * X + x;
  float* dst = out + y * X + x;

  // q[i] holds the column's value at z - R + i, clamped to [0, Z - 1].
  float q[2 * kR + 1];
#pragma unroll
  for (int i = 0; i <= 2 * kR; ++i) {
    int64_t z = i - kR;
    z = z < 0 ? 0 : (z > Z - 1 ? Z - 1 : z);
    q[i] = __ldg(col + z * plane);
  }

  for (int64_t z = 0; z < Z; ++z) {
    const float* p = col + z * plane;
    float acc = c[0] * q[kR];
#pragma unroll
    for (int r = 1; r <= kR; ++r) {
      acc = acc + c[r] * (q[kR - r] + q[kR + r] + __ldg(p + ym[r - 1]) +
                          __ldg(p + yp[r - 1]) + __ldg(p + xm[r - 1]) +
                          __ldg(p + xp[r - 1]));
    }
    dst[z * plane] = acc;
#pragma unroll
    for (int i = 0; i < 2 * kR; ++i) q[i] = q[i + 1];
    const int64_t zn = z + kR + 1 < Z - 1 ? z + kR + 1 : Z - 1;
    q[2 * kR] = __ldg(col + zn * plane);
  }
}

}  // namespace

extern "C" int um_fdtd3d_f32(const float* in, const float* coeffs, float* out,
                             int64_t Z, int64_t Y, int64_t X, void* stream) {
  if (Z <= 0 || Y <= 0 || X <= 0) return cudaErrorInvalidValue;
  const dim3 block(kTX, kTY);
  const dim3 grid(static_cast<unsigned>((X + kTX - 1) / kTX),
                  static_cast<unsigned>((Y + kTY - 1) / kTY));
  fdtd3d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      in, coeffs, out, Z, Y, X);
  return cudaGetLastError();
}
