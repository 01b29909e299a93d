// Text for the codes that the entry points of this library return: 0 for a
// launch that was accepted, a cudaError_t, or a negative code for an argument
// that a kernel does not take.

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  if (code < 0) return "shape, type or argument not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
