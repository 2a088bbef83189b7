// Composite 64-bit selection keys and block-wide selection over them,
// shared by the mips kernel (threshold path) and the assign tile kernel.
//
// key(score, row) = (ordered score bits << 32) | (0xFFFFFFFF - row). The
// ordered bits map fp32 to uint32 monotonically (negative floats flipped,
// positive ones offset by the sign bit; -0.0 is folded into +0.0 first),
// so "larger key" is exactly "larger score, then lower row" — the top-k
// order of lax.top_k — and keys of distinct rows never tie. Key 0 lies
// below every key of a real row (even -inf or NaN scores give a non-zero
// high word), so it pads a buffer without ever being selected ahead of one.
#pragma once

#include "common.cuh"

typedef unsigned long long key64;

__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned b = __float_as_uint(v + 0.0f);  // -0.0 + 0.0 = +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float ordered_value(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ key64 make_key(unsigned ordered, unsigned row) {
  return ((key64)ordered << 32) | (key64)(0xffffffffu - row);
}

__device__ __forceinline__ float key_score(key64 key) {
  return ordered_value((unsigned)(key >> 32));
}

__device__ __forceinline__ int key_row(key64 key) {
  return (int)(0xffffffffu - (unsigned)key);
}

// Exact top-k threshold, block-wide: returns t such that exactly k of the
// block's keys are >= t. Each thread holds some of the keys (0 marks none)
// and supplies count_ge(s, c): c[j] = the number of its own keys >= s[j]
// for the kSplit splitters s[0..kSplit), and local_max, the largest of
// its keys. The keys must be unique and more than k of them non-zero.
// Each step cuts [lo, hi) (count(>= lo) > k > count(>= hi)) at kSplit
// evenly spaced splitters and keeps the part where the count crosses k,
// so it resolves 3 bits; it stops at the first splitter with exactly k
// keys at or above it, which exists because keys are unique (about 8
// steps when the scores differ in their high bits). A step's counts go
// through one warp reduction each, a per-warp slot in shared memory and
// one barrier: no histogram and no atomics, so equal high bits cost
// nothing extra. Every thread of the block calls it; `wcnt` holds
// 2 * kSplit * 32 words, `smax` one key.
constexpr int kSplit = 7;
constexpr int kRankCap = 2048;  // candidates a block ranks (block_rank_emit)

template <typename CountGe>
__device__ key64 block_topk_threshold(key64 local_max, int k, CountGe count_ge,
                                      unsigned* wcnt, key64* smax) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    local_max = max(local_max, __shfl_xor_sync(REPRO_FULL_MASK, local_max, o));
  __syncthreads();  // the previous call's readers are done with smax and wcnt
  if (threadIdx.x == 0) *smax = 0;
  __syncthreads();
  if (lane == 0) atomicMax(smax, local_max);
  __syncthreads();
  key64 lo = 0, hi = *smax + 1;
  for (int it = 0;; ++it) {
    const key64 step = (hi - lo + kSplit) / (kSplit + 1);  // >= 1
    key64 sp[kSplit];
    unsigned c[kSplit];
#pragma unroll
    for (int j = 0; j < kSplit; ++j) {
      sp[j] = min(lo + (key64)(j + 1) * step, hi - 1);  // in (lo, hi): key 0 never counts
      c[j] = 0;
    }
    count_ge(sp, c);
    unsigned* w = wcnt + (it & 1) * kSplit * 32;  // the other half was read before
#pragma unroll                                    // the last barrier
    for (int j = 0; j < kSplit; ++j) {
      const unsigned t = __reduce_add_sync(REPRO_FULL_MASK, c[j]);
      if (lane == 0) w[j * 32 + warp] = t;
    }
    __syncthreads();
    int hit = -1, above = -1;  // splitter with exactly k; last one with more than k
#pragma unroll
    for (int j = 0; j < kSplit; ++j) {
      const unsigned t = __reduce_add_sync(REPRO_FULL_MASK, lane < nw ? w[j * 32 + lane] : 0u);
      if (t == (unsigned)k && hit < 0) hit = j;
      if (t > (unsigned)k) above = j;
    }
    if (hit >= 0) return sp[hit];
    const key64 nlo = above >= 0 ? sp[above] : lo;
    hi = above + 1 < kSplit ? sp[above + 1] : hi;
    lo = nlo;
  }
}

// A cheap lower bound t for the block's k largest keys, held SLOTS per
// thread (0 = none, the rest unique): each warp finds its j largest keys
// (j = ceil(k / warps), by j rounds of a warp max with no barrier), and t
// is the k-th largest of those j * warps keys, found by ranking them. They
// are real keys, so k keys are >= t, and the block's k-th key is too; the
// keys >= t are usually a little over k (the caller checks the count).
// Returns 0 where that fails (j > 8, or fewer than k of the warps' keys:
// short or mostly empty blocks); the caller then searches exactly. Every
// thread of the block calls it; `sbound` is one shared key.
template <int SLOTS>
__device__ key64 block_topk_bound(const key64 (&keys)[SLOTS], int k, key64* sbound) {
  __shared__ key64 tops[32 * 8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int j = (k + nw - 1) / nw;
  if (j > 8) return 0;  // block-uniform
  key64 w = ~0ull;  // the warp's r-th largest key: the largest below the last
  for (int r = 0; r < j; ++r) {
    key64 m = 0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (keys[s] < w) m = max(m, keys[s]);
    for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(REPRO_FULL_MASK, m, o));
    w = m;  // 0 once the warp has no more keys
    if (lane == 0) tops[warp * j + r] = w;
  }
  __syncthreads();  // tops written; the previous call's readers of sbound done
  if (threadIdx.x == 0) *sbound = 0;
  __syncthreads();
  const int T = nw * j;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const key64 mine = tops[i];
    if (mine == 0) continue;
    int rank = 0;
    for (int x = 0; x < T; ++x) rank += tops[x] > mine;
    if (rank == k - 1) *sbound = mine;  // one thread: the keys are unique
  }
  __syncthreads();
  return *sbound;
}

// The k largest of buf[0, n) (unique keys; n >= k) by rank, the number of
// larger keys: emit(rank, key) for each rank < k, one thread each. A key
// a thread; every thread of the block calls it after a barrier that made
// buf visible.
template <typename Emit>
__device__ void block_rank_emit(const key64* buf, int n, int k, Emit emit) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const key64 mine = buf[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += buf[j] > mine;
    if (rank < k) emit(rank, mine);
  }
}

// Block-wide bitonic sort of buf[0, P) into descending order; P is a power
// of two. Every thread of the block calls it.
__device__ void block_bitonic_desc(key64* buf, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (P >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const key64 a = buf[lo], b = buf[hi];
        const bool desc = (lo & size) == 0;
        if (desc ? a < b : a > b) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Appends `key` to out[0, cap) where `take` holds, at a position from a
// shared counter (warp-aggregated); positions past cap are counted, not
// written. Every lane of the warp calls it.
__device__ __forceinline__ void warp_append(bool take, key64 key, key64* out, int cap,
                                            int* count) {
  const int lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(REPRO_FULL_MASK, take);
  if (!m) return;
  int base = 0;
  if (lane == __ffs(m) - 1) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(REPRO_FULL_MASK, base, __ffs(m) - 1);
  if (take) {
    const int pos = base + __popc(m & ((1u << lane) - 1u));
    if (pos < cap) out[pos] = key;
  }
}
