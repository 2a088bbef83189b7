// EmbeddingBag: a weighted gather of table rows, summed into bags, or
// averaged over each bag's entry count.
//
// Replaces: src/repro/kernels/bag/bag.py::embedding_bag_pallas (_bag_kernel).
//
// out[b] = sum_{i: seg[i] == b} w[i] * table[idx[i]] in fp32 (bf16 rows are
// widened first); mean divides by the bag's number of entries, end - start,
// not by the sum of its weights (MIND's profile passes w = mask and means
// over the whole history); empty bags are zero. The TPU kernel runs one grid
// step per entry and accumulates into the output block of its bag; its
// wrapper sorts the entries by bag first (a stable argsort). The wrapper
// here does the same sort, so each bag's entries are contiguous in their
// original order, and this kernel sums them in that order, one warp per
// bag: no atomics, and the result is deterministic.
//
// The warp finds its bag's range [lower_bound(b), lower_bound(b + 1)) in
// the sorted segment ids (lanes 0 and 1 search at once), then walks the
// range: 32 entries' (index, weight) pairs are loaded at once, one a lane,
// and broadcast by shuffles; each lane accumulates its lane-strided columns
// of the row (at d = 64, two floats a lane: one coalesced 256 B row).
// Products and sums are rounded separately (no fused multiply-add), as the
// plain version computes them. Row offsets idx * d are 64-bit.
//
// Bound on this card: bytes. A call must read each distinct row once, the
// 12 bytes of (index, segment, weight) per entry and write the bags;
// 2 * L * d operations are far below that. At MIND's serve_p99 (L = 25,600
// entries of d = 64 into 512 bags) that is a few MB: the time is the
// latency of each warp's chain of row loads, which the unrolled walk keeps
// a few deep. Widths above 128 columns take several passes over the range.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kColsPerLane = 4;  // one pass covers 128 columns

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// First position in seg[0, L) whose value is >= b (L if none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ seg, int L, int b) {
  int lo = 0, hi = L;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (seg[mid] < b)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void bag_kernel(const T* __restrict__ table, int d, const int* __restrict__ idx,
                           const int* __restrict__ seg, const float* __restrict__ w, int L,
                           int num_bags, int mean, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= num_bags) return;  // warp-uniform
  int pos = 0;
  if (lane < 2) pos = lower_bound(seg, L, b + lane);
  const int start = __shfl_sync(REPRO_FULL_MASK, pos, 0);
  const int end = __shfl_sync(REPRO_FULL_MASK, pos, 1);
  float* ob = out + (size_t)b * d;
  for (int c0 = 0; c0 < d; c0 += 32 * kColsPerLane) {
    float acc[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.f;
    for (int i0 = start; i0 < end; i0 += 32) {
      const int mine = i0 + lane;
      const int my_idx = mine < end ? idx[mine] : 0;
      const float my_w = mine < end ? w[mine] : 0.f;
      const int n = min(32, end - i0);  // warp-uniform
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const int r = __shfl_sync(REPRO_FULL_MASK, my_idx, t);
        const float wt = __shfl_sync(REPRO_FULL_MASK, my_w, t);
        const T* row = table + (size_t)r * d;
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < d) acc[j] = __fadd_rn(acc[j], __fmul_rn(widen(row[c]), wt));
        }
      }
    }
    const int cnt = end - start;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < d) ob[c] = (mean && cnt > 0) ? acc[j] / (float)cnt : acc[j];
    }
  }
}

}  // namespace

// table [V, d] (float32, or bfloat16 when bf16 != 0); idx, seg, w [L] sorted
// by seg ascending, seg in [0, num_bags); out [num_bags, d] float32.
extern "C" int bag_launch(const void* table, int bf16, int d, const int* idx,
                          const int* seg, const float* w, int L, int num_bags, int mean,
                          float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (num_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (bf16)
    bag_kernel<<<blocks, 32 * kWarpsPerBlock, 0, st>>>(
        (const __nv_bfloat16*)table, d, idx, seg, w, L, num_bags, mean, out);
  else
    bag_kernel<<<blocks, 32 * kWarpsPerBlock, 0, st>>>((const float*)table, d, idx, seg,
                                                       w, L, num_bags, mean, out);
  return (int)cudaGetLastError();
}
