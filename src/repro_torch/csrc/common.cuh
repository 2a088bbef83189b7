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

// One row of d floats, read by one warp in chunks of 4 floats a lane.
// VEC (d % 4 == 0, 16-byte aligned rows): chunk j of a lane is floats
// [4 (lane + 32 j), +4), one 16-byte load; otherwise floats
// lane + 32 (4 j + e), e < 4, four coalesced 4-byte loads. Floats past d
// read as 0 and are never written.
template <bool VEC>
__device__ __forceinline__ int chunk_pos(int lane, int j, int e) {
  return VEC ? 4 * (lane + 32 * j) + e : lane + 32 * (4 * j + e);
}

template <bool VEC>
__device__ __forceinline__ void load_chunk(const float* __restrict__ row, int d, int lane,
                                           int j, float (&v)[4]) {
  if (VEC) {
    const int p = chunk_pos<true>(lane, j, 0);
    const float4 t = p < d ? *(const float4*)(row + p) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = chunk_pos<false>(lane, j, e);
      v[e] = p < d ? row[p] : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_chunk(float* __restrict__ row, int d, int lane, int j,
                                            const float (&v)[4]) {
  if (VEC) {
    const int p = chunk_pos<true>(lane, j, 0);
    if (p < d) *(float4*)(row + p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = chunk_pos<false>(lane, j, e);
      if (p < d) row[p] = v[e];
    }
  }
}

// sum_e v[e] * w[pos(e)] over a chunk, w a row of d floats (shared memory)
template <bool VEC>
__device__ __forceinline__ float chunk_dot(const float (&v)[4], const float* w, int d,
                                           int lane, int j) {
  float p = 0.f;
  if (VEC) {
    const int q = chunk_pos<true>(lane, j, 0);
    if (q < d) {
      const float4 t = *(const float4*)(w + q);
      p = v[0] * t.x + v[1] * t.y + v[2] * t.z + v[3] * t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = chunk_pos<false>(lane, j, e);
      if (q < d) p += v[e] * w[q];
    }
  }
  return p;
}

// A warp's row, held in registers as NV chunks a lane (rows of up to 128 NV
// floats); NV = 0 holds nothing and reads the row again, chunk by chunk,
// on every pass (any d). divide(s) makes every later pass see v / s (the
// held chunks are divided once; a reread divides as it loads, the same
// IEEE division).
template <int NV, bool VEC>
struct WarpRow {
  const float* src;
  int d, lane;
  float s = 1.f;
  float held[NV > 0 ? NV : 1][4];

  __device__ __forceinline__ WarpRow(const float* row, int d_, int lane_)
      : src(row), d(d_), lane(lane_) {
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) load_chunk<VEC>(src, d, lane, j, held[j]);
    }
  }

  // f(j, chunk j's four floats) for every chunk, in order
  template <class F>
  __device__ __forceinline__ void each(F f) {
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) f(j, held[j]);
    } else {
      const int chunks = (d + 127) / 128;
      for (int j = 0; j < chunks; ++j) {
        float v[4];
        load_chunk<VEC>(src, d, lane, j, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = v[e] / s;  // exact while s == 1
        f(j, v);
      }
    }
  }

  __device__ __forceinline__ void divide(float by) {
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) held[j][e] = held[j][e] / by;
    } else {
      s = by;
    }
  }

  // whether every float of the row is +-0 (then v / s is v, bit for bit)
  __device__ __forceinline__ bool all_zero() {
    bool z = true;
    each([&](int, const float(&v)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) z = z && v[e] == 0.f;
    });
    return __all_sync(REPRO_FULL_MASK, z);
  }

  // sum of squares over the lane's floats (warp_sum it for the row's)
  __device__ __forceinline__ float sumsq() {
    float ss = 0.f;
    each([&](int, const float(&v)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ss += v[e] * v[e];
    });
    return ss;
  }
};

// The screen's sum over the n basis rows of warp_sum(sum_t (v_t * xs) *
// vn_i[t]), added in the order of i (vn [n][d] in shared memory).
template <int NV, bool VEC>
__device__ __forceinline__ float screen_sum(WarpRow<NV, VEC>& row, const float* vn, int n,
                                            int d, int lane, float xs) {
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    float p = 0.f;
    row.each([&](int ch, const float(&v)[4]) {
      const float u[4] = {v[0] * xs, v[1] * xs, v[2] * xs, v[3] * xs};
      p += chunk_dot<VEC>(u, vn + (size_t)i * d, d, lane, ch);
    });
    acc += warp_sum(p);
  }
  return acc;
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
