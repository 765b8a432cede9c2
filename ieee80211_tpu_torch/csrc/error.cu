// Error text for the codes that the launch functions return.
#include <cuda_runtime.h>

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
