// Error strings for the codes the kernel entry points return.
#include "common.cuh"

KM_EXPORT const char* km_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
