// Black-Scholes European option pricing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bs_kernel in
// src/repro/kernels/black_scholes/kernel.py, which streams (rows, 128) tiles
// of S, X, T through VMEM and needs its wrapper to pad the arrays with ones.
//
// Bound on the H100: device memory.  Each option reads S, X, T and writes
// CALL and PUT, 20 bytes, against some 60 fp32 operations: 3 flop per byte,
// far below the card's 20 flop/byte fp32 ridge (67 TFLOP/s over 3.35 TB/s).
// Design: one thread prices four options with 16-byte loads and stores when
// all five pointers are 16-byte aligned, else one option at a time.  No
// padding pass: the ragged tail is masked.  The math is the precise fp32
// logf/expf/sqrtf/erff (the build does not use --use_fast_math), so the
// kernel stays within 1e-4 of the fp32 plain version.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

struct BsParams {
  float v;     // volatility
  float mu;    // r + v^2 / 2, folded in double on the host as JAX folds it
  float neg_r; // -r
};

__device__ __forceinline__ float ncdf(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678f));
}

__device__ __forceinline__ void price(float s, float x, float t,
                                      const BsParams& p, float& call,
                                      float& put) {
  const float sqrt_t = sqrtf(t);
  const float d1 = (logf(s / x) + p.mu * t) / (p.v * sqrt_t);
  const float d2 = d1 - p.v * sqrt_t;
  const float disc = expf(p.neg_r * t);
  call = s * ncdf(d1) - x * disc * ncdf(d2);
  put = x * disc * ncdf(-d2) - s * ncdf(-d1);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    bs_kernel(const float* __restrict__ s, const float* __restrict__ x,
              const float* __restrict__ t, float* __restrict__ call,
              float* __restrict__ put, int64_t n, BsParams p) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPerThread;
  if (i >= n) return;
  if (kVec && i + kPerThread <= n) {
    const float4 sv = __ldg(reinterpret_cast<const float4*>(s + i));
    const float4 xv = __ldg(reinterpret_cast<const float4*>(x + i));
    const float4 tv = __ldg(reinterpret_cast<const float4*>(t + i));
    float4 cv, pv;
    price(sv.x, xv.x, tv.x, p, cv.x, pv.x);
    price(sv.y, xv.y, tv.y, p, cv.y, pv.y);
    price(sv.z, xv.z, tv.z, p, cv.z, pv.z);
    price(sv.w, xv.w, tv.w, p, cv.w, pv.w);
    *reinterpret_cast<float4*>(call + i) = cv;
    *reinterpret_cast<float4*>(put + i) = pv;
    return;
  }
  const int64_t end = i + kPerThread < n ? i + kPerThread : n;
  for (int64_t j = i; j < end; ++j) price(s[j], x[j], t[j], p, call[j], put[j]);
}

}  // namespace

extern "C" int um_black_scholes_f32(const float* s, const float* x,
                                    const float* t, float* call, float* put,
                                    int64_t n, double r, double v,
                                    void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const BsParams p{static_cast<float>(v), static_cast<float>(r + 0.5 * v * v),
                   static_cast<float>(-r)};
  const uintptr_t addr = reinterpret_cast<uintptr_t>(s) |
                         reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(t) |
                         reinterpret_cast<uintptr_t>(call) |
                         reinterpret_cast<uintptr_t>(put);
  const int64_t groups = (n + kPerThread - 1) / kPerThread;
  const dim3 grid(static_cast<unsigned>((groups + kThreads - 1) / kThreads));
  auto st = static_cast<cudaStream_t>(stream);
  if (addr % 16 == 0)
    bs_kernel<true><<<grid, kThreads, 0, st>>>(s, x, t, call, put, n, p);
  else
    bs_kernel<false><<<grid, kThreads, 0, st>>>(s, x, t, call, put, n, p);
  return cudaGetLastError();
}
