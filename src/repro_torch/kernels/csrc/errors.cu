// The CUDA runtime's name for an error code that an entry point returned.
#include <cuda_runtime.h>

extern "C" const char* um_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
