// Error text for the cudaError_t codes the launchers return.
#include <cuda_runtime.h>

extern "C" const char* wf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
