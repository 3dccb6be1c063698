// Shared C entry point of the kernel library: CUDA error text for the
// codes the other entry points return.
#include <cuda_runtime.h>

extern "C" const char* im23d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
