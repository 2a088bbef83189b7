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
// wrapper sorts the entries by bag first (a stable argsort). This kernel
// takes entries already sorted by bag (seg non-decreasing): the port's
// sorting wrapper does that sort, and a caller whose segments are sorted by
// construction (MIND: seg = arange(B) repeated S times) launches it alone,
// on its own int32 or int64 indices and segments, with no sort, gather or
// cast. Each bag's entries are contiguous in their original order, and one
// warp sums them in that order: no atomics, and the result is
// deterministic.
//
// The warp finds its bag's range in the segment ids, then walks it: 32
// entries' (index, weight) pairs are loaded at once, one a lane, while the
// previous 32 are summed, and broadcast by shuffles; each lane owns V
// neighbouring columns (V = 2 at d = 64: one 256 B row a warp instruction,
// 8 bytes a lane; V = 4 covers 128 columns a pass, V = 1 rows of odd width
// or alignment), and U rows are loaded before they are summed. Two regimes,
// picked by the number of bags against the warps the card holds at once
// (sms * 64, the caller's SM count): few bags (MIND's serve_p99: 512 warps
// on a card that holds 8,448) leave the card mostly idle, so a bag's own
// latency is the kernel's: a 16-ary search in each half-warp (bag_range: 4
// rounds of parallel probes where a binary search makes 15 dependent
// loads) and U = 4; many bags (serve_bulk: 262,144) keep every SM full, so
// the fewest loads win: a binary search by two lanes and U = 2. They are
// two kernels, for their register budgets (each measured with
// tools/kernel_ab.py against a copy with the other's bound, H100 80GB HBM3
// at 700 W; PERF.md): many bags keep __launch_bounds__(256) alone, under
// which the compiler sizes a thread for a full SM (with
// __launch_bounds__(256, 1) it takes more registers, and serve_bulk took
// 16% longer); few bags take __launch_bounds__(256, 1), and a fifth less
// time at serve_p99 than with (256) alone. Entries are summed in their
// order, with products and sums rounded separately (no fused
// multiply-add), as the plain version computes them on the CPU. Row
// offsets idx * d are 64-bit.
//
// Bound on this card: bytes. A call must read each distinct row once, the
// (index, segment, weight) of each entry and write the bags; 2 * L * d
// operations are far below that. At MIND's serve_p99 (L = 25,600 entries
// of d = 64 into 512 bags) that is a few MB (0.0004 ms) and the time is
// the latency of a bag's search and row loads: about 0.007 ms on an H100
// 80GB HBM3 at 700 W, against 0.013 for F.embedding_bag + divide; at
// serve_bulk (13.1 M entries, 262,144 bags; bound 0.088 ms) most rows are
// Zipf-hot and served from L1 and L2, and the kernel takes about 0.50 ms,
// against 1.5 for the library call (chip_smoke.py; PERF.md).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kWarpsPerSm = 64;  // warps an SM holds at once

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Bag b's range [start, end) in seg[0, L): the first positions whose id is
// >= b and >= b + 1, found at once by the two half-warps (lanes 0-15 for
// b, 16-31 for b + 1). Each round, a half probes 16 evenly spaced
// positions inside [lo, hi) at once and keeps the gap where the ids cross
// its target, so a search takes about log_17(L) rounds of one load a lane
// (6 at L = 13.1 M) where a binary search takes log_2(L) dependent loads
// (24); once a gap holds 16 positions or fewer, one last round counts it.
// Every lane of the warp calls it.
template <typename ST>
__device__ __forceinline__ void bag_range(const ST* __restrict__ seg, int L, int b, int& start,
                                          int& end) {
  const int lane = threadIdx.x & 31, hl = lane & 15, half = lane >> 4;
  const long long target = (long long)b + half;
  int lo = 0, hi = L;  // the half's answer lies in [lo, hi]
  do {
    const int n = hi - lo;
    const bool last = n <= 16;
    const int p = last ? lo + hl : lo + (int)((long long)n * (hl + 1) / 17);
    const bool below = p < hi && (long long)seg[p] < target;
    const int c = __popc((__ballot_sync(REPRO_FULL_MASK, below) >> (16 * half)) & 0xFFFFu);
    if (last) {  // the c probes below the target are [lo, lo + c)
      lo += c;
      hi = lo;
    } else {  // probe j sits at lo + n (j + 1) / 17; the ids cross between c - 1 and c
      const int plo = c ? lo + (int)((long long)n * c / 17) + 1 : lo;
      hi = c < 16 ? lo + (int)((long long)n * (c + 1) / 17) : hi;
      lo = plo;
    }
  } while (!__all_sync(REPRO_FULL_MASK, lo == hi));
  start = __shfl_sync(REPRO_FULL_MASK, lo, 0);
  end = __shfl_sync(REPRO_FULL_MASK, lo, 16);
}

// The same range by two binary searches, lanes 0 (b) and 1 (b + 1): 2
// log_2(L) loads a bag where bag_range makes about 32 log_17(L).
template <typename ST>
__device__ __forceinline__ void bag_range_binary(const ST* __restrict__ seg, int L, int b,
                                                 int& start, int& end) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = L;
  if (lane < 2) {
    const long long target = (long long)b + lane;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if ((long long)seg[mid] < target)
        lo = mid + 1;
      else
        hi = mid;
    }
  }
  start = __shfl_sync(REPRO_FULL_MASK, lo, 0);
  end = __shfl_sync(REPRO_FULL_MASK, lo, 1);
}

template <typename T, int V, typename IT, typename ST, bool MANY>
__device__ __forceinline__ void bag_body(const T* __restrict__ table, int d,
                                         const IT* __restrict__ idx, const ST* __restrict__ seg,
                                         const float* __restrict__ w, int L, int num_bags,
                                         int mean, float* __restrict__ out) {
  constexpr int U = MANY ? 2 : 4;  // rows a warp loads before it sums them
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= num_bags) return;  // warp-uniform
  int start, end;
  if constexpr (MANY)
    bag_range_binary(seg, L, b, start, end);
  else
    bag_range(seg, L, b, start, end);
  float* ob = out + (size_t)b * d;
  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    const int col = c0 + lane * V;
    const bool act = col < d;  // d % V == 0: a lane's V columns are all in range or none
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    long long nidx = start + lane < end ? (long long)idx[start + lane] : 0;
    float nw = start + lane < end ? (w ? w[start + lane] : 1.f) : 0.f;
    for (int i0 = start; i0 < end; i0 += 32) {
      const long long my_idx = nidx;
      const float my_w = nw;
      const int nx = i0 + 32 + lane;  // the next 32 entries, loaded while these are summed
      nidx = nx < end ? (long long)idx[nx] : 0;
      nw = nx < end ? (w ? w[nx] : 1.f) : 0.f;
      const int n = min(32, end - i0);  // warp-uniform
      for (int t0 = 0; t0 < n; t0 += U) {
        Pack<T, V> rows[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long r = __shfl_sync(REPRO_FULL_MASK, my_idx, (t0 + u) & 31);
          if (t0 + u < n && act) rows[u] = *(const Pack<T, V>*)(table + r * d + col);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float wt = __shfl_sync(REPRO_FULL_MASK, my_w, (t0 + u) & 31);
          if (t0 + u < n && act) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[v] = __fadd_rn(acc[v], __fmul_rn(widen(rows[u].v[v]), wt));
          }
        }
      }
    }
    const int cnt = end - start;
    if (act) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        ob[col + v] = (mean && cnt > 0) ? acc[v] / (float)cnt : acc[v];
    }
  }
}

// Few bags: registers as the body needs them (one block an SM at least).
template <typename T, int V, typename IT, typename ST>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, 1)
    bag_few_kernel(const T* __restrict__ table, int d, const IT* __restrict__ idx,
                   const ST* __restrict__ seg, const float* __restrict__ w, int L,
                   int num_bags, int mean, float* __restrict__ out) {
  bag_body<T, V, IT, ST, false>(table, d, idx, seg, w, L, num_bags, mean, out);
}

// Many bags: the compiler's default for 256 threads (registers for a full SM).
template <typename T, int V, typename IT, typename ST>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    bag_many_kernel(const T* __restrict__ table, int d, const IT* __restrict__ idx,
                    const ST* __restrict__ seg, const float* __restrict__ w, int L,
                    int num_bags, int mean, float* __restrict__ out) {
  bag_body<T, V, IT, ST, true>(table, d, idx, seg, w, L, num_bags, mean, out);
}

template <typename T, int V, typename IT, typename ST>
cudaError_t launch(const void* table, int d, const void* idx, const void* seg, const float* w,
                   int L, int num_bags, int mean, int sms, float* out, cudaStream_t st) {
  const int blocks = (num_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (num_bags > sms * kWarpsPerSm)
    bag_many_kernel<T, V, IT, ST><<<blocks, 32 * kWarpsPerBlock, 0, st>>>(
        (const T*)table, d, (const IT*)idx, (const ST*)seg, w, L, num_bags, mean, out);
  else
    bag_few_kernel<T, V, IT, ST><<<blocks, 32 * kWarpsPerBlock, 0, st>>>(
        (const T*)table, d, (const IT*)idx, (const ST*)seg, w, L, num_bags, mean, out);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_v(const void* table, int d, const void* idx, int idx64, const void* seg,
                     int seg64, const float* w, int L, int num_bags, int mean, int sms,
                     float* out, cudaStream_t st) {
  if (idx64)
    return seg64 ? launch<T, V, long long, long long>(table, d, idx, seg, w, L, num_bags, mean, sms, out, st)
                 : launch<T, V, long long, int>(table, d, idx, seg, w, L, num_bags, mean, sms, out, st);
  return seg64 ? launch<T, V, int, long long>(table, d, idx, seg, w, L, num_bags, mean, sms, out, st)
               : launch<T, V, int, int>(table, d, idx, seg, w, L, num_bags, mean, sms, out, st);
}

template <typename T>
cudaError_t launch_t(const void* table, int d, const void* idx, int idx64, const void* seg,
                     int seg64, const float* w, int L, int num_bags, int mean, int sms,
                     float* out, cudaStream_t st) {
  // the fewest columns a lane that covers d in one pass (at most 4), as the
  // width and the table's alignment allow
  int v = d <= 32 ? 1 : d <= 64 ? 2 : 4;
  while (v > 1 && (d % v || (uintptr_t)table % (v * sizeof(T)))) v >>= 1;
  switch (v) {
    case 4: return launch_v<T, 4>(table, d, idx, idx64, seg, seg64, w, L, num_bags, mean, sms, out, st);
    case 2: return launch_v<T, 2>(table, d, idx, idx64, seg, seg64, w, L, num_bags, mean, sms, out, st);
    default: return launch_v<T, 1>(table, d, idx, idx64, seg, seg64, w, L, num_bags, mean, sms, out, st);
  }
}

}  // namespace

// table [V, d] (float32, or bfloat16 when bf16 != 0), contiguous; idx, seg
// [L] int32 (int64 where idx64 / seg64), seg non-decreasing in
// [0, num_bags); w [L] float32 or null (every weight 1); out [num_bags, d]
// float32; sms: the card's streaming multiprocessors.
extern "C" int bag_launch(const void* table, int bf16, int d, const void* idx, int idx64,
                          const void* seg, int seg64, const float* w, int L, int num_bags,
                          int mean, int sms, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return (int)launch_t<__nv_bfloat16>(table, d, idx, idx64, seg, seg64, w, L, num_bags,
                                        mean, sms, out, st);
  return (int)launch_t<float>(table, d, idx, idx64, seg, seg64, w, L, num_bags, mean, sms, out, st);
}
