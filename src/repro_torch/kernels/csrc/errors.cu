// Error text for the cudaError_t codes the other entry points return.
#include <cuda_runtime.h>

extern "C" const char* coconut_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
