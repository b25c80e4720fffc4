// Error reporting for the plain C interface of the kernel library.
#include <cuda_runtime.h>

extern "C" const char* vsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
