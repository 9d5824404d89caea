// Loads shared by the fp32 (CUDA-core) flash and paged attention kernels:
// N consecutive fp32 elements in one vector access.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace um_attn {

constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF

// The raw bits of N consecutive elements of T, loaded in one access.
template <typename T, int N>
struct Raw;
template <>
struct Raw<float, 4> { float4 v; };
template <>
struct Raw<float, 2> { float2 v; };
template <>
struct Raw<float, 1> { float v; };

// Read-only load of N elements at p, which is aligned to N elements.
template <typename T, int N>
__device__ __forceinline__ Raw<T, N> load_raw(const T* p) {
  using V = decltype(Raw<T, N>::v);
  return Raw<T, N>{__ldg(reinterpret_cast<const V*>(p))};
}

template <typename T, int N>
__device__ __forceinline__ Raw<T, N> zero_raw() {
  Raw<T, N> r;
  r.v = {};
  return r;
}

// The N raw elements as fp32.
template <int N>
__device__ __forceinline__ void widen(const Raw<float, N>& r, float* out) {
  const float* f = reinterpret_cast<const float*>(&r.v);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = f[i];
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}

}  // namespace um_attn
