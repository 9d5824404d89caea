// Tiled GEMM C = A @ B with an fp32 accumulator, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mm_kernel in
// src/repro/kernels/streamed_matmul/kernel.py, a K-blocked product on the
// MXU whose wrapper pads M to a multiple of 8 and K, N to multiples of 128.
//
// Bound on the H100: compute at the paper's size.  An n x n product does
// 2n^3 operations on 12n^2 bytes, n/6 flop per byte: far above the fp32
// ridge (67 TFLOP/s over 3.35 TB/s is 20 flop/byte) once n is a few hundred.
// The products are IEEE fp32 FMAs on the CUDA cores: no TF32 and no tensor
// cores, so the result keeps the fp32 tolerance of the JAX tests at any K.
// Design: a 128 x 128 output tile per block of 256 threads, 8 deep in K.
// Each thread owns an 8 x 8 register tile, split in two 4-wide halves 64
// rows and 64 columns apart, so its shared-memory reads are 16-byte vectors
// that no two threads of a half-warp take from the same bank.  A is staged
// k-major (transposed) with 4 floats of padding so that staging it is free
// of bank conflicts too.  The next K tile is loaded into registers while the
// current one is multiplied.  Ragged edges of M, N and K are masked: loads
// outside the matrices read zero and stores outside are skipped, so the
// wrapper pads nothing.  bf16 inputs are widened to fp32 as they are staged
// and the fp32 sum is rounded to bf16 (to nearest even) as it is stored.
// wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8;
constexpr int kThreads = 256;
constexpr int kLoads = kBM * kBK / kThreads;  // elements of A (and of B) a thread stages
constexpr int kPadA = 4;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ c, int64_t M, int64_t N, int64_t K) {
  __shared__ __align__(16) float As[kBK][kBM + kPadA];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;

  float a_next[kLoads], b_next[kLoads];
  auto load_tile = [&](int64_t k0) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int idx = tid + j * kThreads;
      const int64_t am = m0 + idx / kBK, ak = k0 + idx % kBK;
      a_next[j] = (am < M && ak < K) ? widen(a[am * K + ak]) : 0.0f;
      const int64_t bk = k0 + idx / kBN, bn = n0 + idx % kBN;
      b_next[j] = (bk < K && bn < N) ? widen(b[bk * N + bn]) : 0.0f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_tile(0);
  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int idx = tid + j * kThreads;
      As[idx % kBK][idx / kBK] = a_next[j];
      Bs[idx / kBN][idx % kBN] = b_next[j];
    }
    __syncthreads();
    if (k0 + kBK < K) load_tile(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t n = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (n < N) c[m * N + n] = narrow<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const T* a, const T* b, T* c, int64_t M, int64_t N, int64_t K,
           void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  gemm_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" int um_gemm_f32(const float* a, const float* b, float* c, int64_t M,
                           int64_t N, int64_t K, void* stream) {
  return launch(a, b, c, M, N, K, stream);
}

extern "C" int um_gemm_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                            __nv_bfloat16* c, int64_t M, int64_t N, int64_t K,
                            void* stream) {
  return launch(a, b, c, M, N, K, stream);
}
