// An empty kernel: the launch floor. chip_smoke.py times it with the same
// CUDA events as the kernels, so a kernel's time can be read against what
// one launch on the caller's stream costs on this card. No TPU kernel.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
