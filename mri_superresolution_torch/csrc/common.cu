#include "common.cuh"

extern "C" const char* msr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
