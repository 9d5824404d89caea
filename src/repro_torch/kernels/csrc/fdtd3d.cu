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
// below the card's 20 flop/byte fp32 ridge; 4.10 ms at (1192, 1200, 1200).
//
// Design: the CUDA FDTD3d sample's structure, with the loads of several
// planes in flight.  A block of 256 threads owns a 16 x 64 tile of (x, y)
// columns, each thread 4 adjacent x outputs, and walks it down a chunk of
// up to 64 z planes.  Shared memory holds a ring of 8 x-y planes of the
// tile with its halo of 4, (16 + 8) x (64 + 8) floats each (55 KB): while
// plane z is computed, planes z .. z+4 are resident, z+5 and z+6 are on
// their way, and plane z+7 is issued into the slot that plane z-1 left.
// The ring is filled with cp.async, 16 bytes a copy where X % 4 == 0 and
// the four floats lie inside the grid, 4 bytes a copy otherwise.  Neighbour
// indices are clamped to the grid's edge as the ring is filled, which is
// exactly edge padding, so no padded copy is written.  A thread reads its
// in-plane neighbours from plane z as 16-byte vectors (3 along x and 8
// along y serve its 4 outputs) and keeps the z neighbours, z-4 .. z+4, in a
// register queue per output whose newest value comes from plane z+4 of the
// ring.  114 registers, no spill: two blocks an SM.  The chunk length,
// the planes in flight and the block count an SM were chosen by timing on
// an H100.
// TMA is not used: its out-of-bounds fill is zero, not the edge, so the
// faces would need a fix-up pass, and it needs 16-byte row strides, which an
// X that is not a multiple of 4 does not have.  Offsets are 64-bit: a grid
// may hold more than 2^31 cells.
#include <cuda_runtime.h>

#include "smem_limit.cuh"

#include <cstdint>

namespace {

constexpr int kR = 4;
constexpr int kTX = 64, kTY = 16;          // outputs of a block
constexpr int kVec = 4;                    // adjacent x outputs of a thread
constexpr int kThreads = kTX / kVec * kTY;  // 256
constexpr int kW = kTX + 2 * kR;           // floats in a row of a ring plane
constexpr int kH = kTY + 2 * kR;           // rows of a ring plane
constexpr int kPlane = kW * kH;            // floats of a ring plane
constexpr int kChunks = kPlane / 4;        // 16-byte chunks of a ring plane
constexpr int kFill = (kChunks + kThreads - 1) / kThreads;  // chunks a thread copies
constexpr int kAhead = 2;                  // planes in flight past z + 4
constexpr int kRing = kR + 1 + kAhead + 1;  // + the slot being refilled
constexpr int kSmem = kRing * kPlane * 4;
constexpr int64_t kZChunk = 64;            // z planes a block walks
static_assert(kW % 4 == 0 && kTX % kVec == 0, "rows hold whole 16-byte chunks");

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of copies are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int64_t clamp(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads, 2)
    fdtd3d_kernel(const float* __restrict__ in, const float* __restrict__ coeffs,
                  float* __restrict__ out, int64_t Z, int64_t Y, int64_t X, int vec) {
  extern __shared__ float4 ring4[];
  const float* ring = reinterpret_cast<const float*>(ring4);
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring4));

  const int tid = threadIdx.x;
  const int64_t x0 = static_cast<int64_t>(blockIdx.x) * kTX;
  const int64_t y0 = static_cast<int64_t>(blockIdx.y) * kTY;
  const int64_t zb = static_cast<int64_t>(blockIdx.z) * kZChunk;
  const int64_t ze = zb + kZChunk < Z ? zb + kZChunk : Z;
  const int64_t plane = Y * X;

  // The chunks of a ring plane this thread copies: row base in the plane
  // (clamped y), first x, and the destination's byte offset in a slot.
  int64_t src_row[kFill], src_x[kFill];
  uint32_t dst_off[kFill];
#pragma unroll
  for (int f = 0; f < kFill; ++f) {
    const int ci = tid + f * kThreads;
    const int row = ci / (kW / 4), cc = ci % (kW / 4);
    src_row[f] = clamp(y0 - kR + row, Y - 1) * X;
    src_x[f] = x0 - kR + 4 * cc;
    dst_off[f] = static_cast<uint32_t>((row * kW + 4 * cc) * 4);
  }
  // Copy plane p (clamped to the grid) into ring slot `slot`; then close
  // the group, empty past the last plane the chunk needs.
  auto fill = [&](int64_t p, int slot) {
    if (p < ze + kR) {
      const float* src = in + clamp(p, Z - 1) * plane;
      const uint32_t dst = ring_s + static_cast<uint32_t>(slot * kPlane * 4);
#pragma unroll
      for (int f = 0; f < kFill; ++f) {
        if (kChunks % kThreads != 0 && tid + f * kThreads >= kChunks) continue;
        const int64_t x = src_x[f];
        if (vec && x >= 0 && x + 3 < X) {
          cp_async16(dst + dst_off[f], src + src_row[f] + x);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cp_async4(dst + dst_off[f] + 4 * e, src + src_row[f] + clamp(x + e, X - 1));
        }
      }
    }
    cp_async_commit();
  };

  // This thread's outputs: row y, columns xt .. xt + 3.
  const int tx = tid % (kTX / kVec), ty = tid / (kTX / kVec);
  const int64_t y = y0 + ty, xt = x0 + kVec * tx;
  const int center = (ty + kR) * kW + kVec * tx + kR;  // in a ring plane

  float c[kR + 1];
#pragma unroll
  for (int r = 0; r <= kR; ++r) c[r] = __ldg(coeffs + r);

  // q[j][i]: output j's column at z - R + i, clamped to the grid; the first
  // 2R values come from device memory, each later one from the ring.
  float q[kVec][2 * kR + 1];
  {
    const int64_t yc = clamp(y, Y - 1) * X;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int64_t xc = clamp(xt + j, X - 1);
#pragma unroll
      for (int i = 0; i < 2 * kR; ++i)
        q[j][i] = __ldg(in + clamp(zb - kR + i, Z - 1) * plane + yc + xc);
    }
  }

  // Planes zb .. zb + kR + kAhead into slots 0 .. kRing - 2.
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) fill(zb + i, i);

  const bool store_vec = vec && y < Y && xt + kVec <= X;
  int slot = 0;  // of plane z
  for (int64_t z = zb; z < ze; ++z) {
    cp_async_wait<kAhead>();  // planes z .. z + kR have landed
    __syncthreads();          // for every thread, and plane z - 1 is read
    const int prev = slot == 0 ? kRing - 1 : slot - 1;
    fill(z + kRing - 1, prev);

    const float* pz = ring + slot * kPlane + center;
    const int ahead = slot + kR < kRing ? slot + kR : slot + kR - kRing;
    const float4 zn = *reinterpret_cast<const float4*>(ring + ahead * kPlane + center);
    q[0][2 * kR] = zn.x;
    q[1][2 * kR] = zn.y;
    q[2][2 * kR] = zn.z;
    q[3][2 * kR] = zn.w;
    // x - 4 .. x + 7 of the row: output j's x neighbour at distance r is
    // e[kR + j -+ r]
    float e[kVec + 2 * kR];
#pragma unroll
    for (int i = 0; i < (kVec + 2 * kR) / 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(pz - kR + 4 * i);
      e[4 * i] = v.x;
      e[4 * i + 1] = v.y;
      e[4 * i + 2] = v.z;
      e[4 * i + 3] = v.w;
    }
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = c[0] * q[j][kR];
#pragma unroll
    for (int r = 1; r <= kR; ++r) {
      const float4 ym = *reinterpret_cast<const float4*>(pz - r * kW);
      const float4 yp = *reinterpret_cast<const float4*>(pz + r * kW);
      const float ymv[kVec] = {ym.x, ym.y, ym.z, ym.w};
      const float ypv[kVec] = {yp.x, yp.y, yp.z, yp.w};
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        acc[j] = acc[j] + c[r] * (q[j][kR - r] + q[j][kR + r] + ymv[j] + ypv[j] +
                                  e[kR + j - r] + e[kR + j + r]);
    }

    if (y < Y) {
      float* dst = out + z * plane + y * X + xt;
      if (store_vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (xt + j < X) dst[j] = acc[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j)
#pragma unroll
      for (int i = 0; i < 2 * kR; ++i) q[j][i] = q[j][i + 1];
    slot = slot + 1 < kRing ? slot + 1 : 0;
  }
  cp_async_wait<0>();  // no copy may outlive the block
}

}  // namespace

extern "C" int um_fdtd3d_f32(const float* in, const float* coeffs, float* out,
                             int64_t Z, int64_t Y, int64_t X, void* stream) {
  if (Z <= 0 || Y <= 0 || X <= 0) return cudaErrorInvalidValue;
  const int64_t gx = (X + kTX - 1) / kTX, gy = (Y + kTY - 1) / kTY;
  const int64_t gz = (Z + kZChunk - 1) / kZChunk;
  if (gx > 2147483647 || gy > 65535 || gz > 65535) return cudaErrorInvalidValue;
  static unsigned long long configured = 0;  // a bit per device
  const cudaError_t err = raise_smem_limit(fdtd3d_kernel, kSmem, configured);
  if (err != cudaSuccess) return err;
  // 16-byte copies and stores need 16-byte aligned rows
  const int vec = X % 4 == 0 && (reinterpret_cast<uintptr_t>(in) |
                                 reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  fdtd3d_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                       static_cast<unsigned>(gz)),
                  kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(in, coeffs, out, Z, Y,
                                                                         X, vec);
  return cudaGetLastError();
}
