// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel library exposes plain C entry points (bound from Python
// with ctypes) that launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() so the wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define REPRO_NEG_INF (-1e30f)
#define REPRO_FULL_MASK 0xffffffffu
// floats of block-reduction scratch: one per warp plus the broadcast slot
#define REPRO_RED_SLOTS 33

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(REPRO_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(REPRO_FULL_MASK, v, o));
  return v;
}

// The top-k order used everywhere: larger value first, then lower index
// (lax.top_k's tie-break).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(REPRO_FULL_MASK, v, o);
    const int oi = __shfl_xor_sync(REPRO_FULL_MASK, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide sum, returned to every thread. blockDim.x is a multiple of 32
// and every thread of the block calls it. `scratch` holds REPRO_RED_SLOTS.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // the previous call's readers are done with scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nw ? scratch[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) scratch[32] = t;
  }
  __syncthreads();
  return scratch[32];
}

__device__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nw ? scratch[lane] : -INFINITY;
    t = warp_max(t);
    if (lane == 0) scratch[32] = t;
  }
  __syncthreads();
  return scratch[32];
}

// Block-wide (max value, lowest index among equals), returned to every
// thread. `fs`/`is` hold REPRO_RED_SLOTS entries each.
__device__ void block_argmax(float& v, int& i, float* fs, int* is) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  warp_argmax(v, i);
  __syncthreads();
  if (lane == 0) {
    fs[warp] = v;
    is[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    float tv = lane < nw ? fs[lane] : -INFINITY;
    int ti = lane < nw ? is[lane] : INT_MAX;
    warp_argmax(tv, ti);
    if (lane == 0) {
      fs[32] = tv;
      is[32] = ti;
    }
  }
  __syncthreads();
  v = fs[32];
  i = is[32];
}

// Raise a kernel's dynamic shared-memory ceiling when it needs more than
// the default 48 KB.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
