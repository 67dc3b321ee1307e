// An empty kernel, launched through the same plain-C entry and ctypes path
// as the port's kernels: chip_smoke.py times it as the floor of a launch and
// prints it beside each kernel's bound.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* empty_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
