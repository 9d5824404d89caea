// Raising a kernel's dynamic shared-memory limit once per device.
//
// cudaFuncSetAttribute acts on the current device's context, so a flag
// kept once per process would leave every device after the first at the
// default 48 KB limit.  Each launcher keeps a bit per device ordinal
// instead (ordinals past 63 raise the limit on every call).
#pragma once

#include <cuda_runtime.h>

template <typename Kernel>
inline cudaError_t raise_smem_limit(Kernel* kernel, int bytes,
                                    unsigned long long& configured) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (configured & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  configured |= bit;
  return cudaSuccess;
}
