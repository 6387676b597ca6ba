// Error text for the launchers' cudaError_t return codes.
#include <cuda_runtime.h>

extern "C" __attribute__((visibility("default"))) const char* smpl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
