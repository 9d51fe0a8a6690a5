// Error strings for the launch checks of kernels/_build.py.
#include <cuda_runtime.h>

extern "C" const char* dagr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
