// Loads shared by the flash and paged attention kernels: N consecutive
// elements of fp32 or bf16 in one vector access, widened to fp32.
#pragma once

#include <cuda_bf16.h>
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
template <>
struct Raw<__nv_bfloat16, 4> { uint2 v; };
template <>
struct Raw<__nv_bfloat16, 2> { unsigned v; };
template <>
struct Raw<__nv_bfloat16, 1> { unsigned short v; };

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

__device__ __forceinline__ float bf16_bits_to_float(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// Widen N raw elements to fp32 (bf16 -> fp32 is exact).
template <int N>
__device__ __forceinline__ void widen(const Raw<float, N>& r, float* out) {
  const float* f = reinterpret_cast<const float*>(&r.v);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = f[i];
}
template <int N>
__device__ __forceinline__ void widen(const Raw<__nv_bfloat16, N>& r, float* out) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(&r.v);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = bf16_bits_to_float(h[i]);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

}  // namespace um_attn
