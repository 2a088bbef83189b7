// The gradient of EmbeddingBag: a dense d_table and, where the weights
// require grad, d_w.
//
// Replaces no TPU kernel: the reference has no backward for
// src/repro/kernels/bag/bag.py::embedding_bag_pallas (jax.grad through it
// raises), and its gradient is the autodiff of
// src/repro/kernels/bag/ref.py::embedding_bag_ref. This kernel computes
// that gradient, term for term, so that a train step on the card goes
// through the bag kernel forward and backward:
//
//   gs[b]       = g[b] / max(c[b], 1)   (c: the bag's entry count; mean mode only)
//   d_table[v]  = sum_{i: idx[i] = v} gs[seg[i]] * w[i]   (w = 1 where null)
//   d_w[i]      = sum_col table[idx[i]][col] * gs[seg[i]][col]
//
// each divide, product and sum rounded on its own (no fused multiply-add,
// no fast math), sums in f32, d_table written in the table's type (f32 or
// bf16). Rows no entry touches are zero: the wrapper allocates d_table
// with torch.zeros, and the kernel writes every touched row once.
//
// The hard part is skew. MIND's profile bag sends every masked history
// position to row 0 with weight 0, and row 0 is also the Zipf head: about
// 2 M of a train batch's 3.28 M entries land on one row, and a batch of
// dummy ids sends all of them there. A design that serialises on a row
// (one warp walking a row's entries, or an f32 atomicAdd from every entry
// onto one row's 64 addresses) collapses there, and atomics would also
// make the sum's order change from run to run.
//
// Design: the wrapper sorts the entry positions by row id (a stable
// torch.sort, so each row's entries keep their original order). Level 1
// cuts the sorted entries into chunks of kChunk; one warp a chunk walks
// it in order, each lane owning V neighbouring columns, and sums each
// run of equal row id in f32. A run strictly inside its chunk is a whole
// row: the warp writes it. The chunk's first and last runs may continue
// in the neighbouring chunks, so the warp emits them as two items (row,
// partial sum); a chunk of one run emits it and a zero item. The items,
// still sorted by row, are the next level's entries: kChunk of them a
// warp, the same rule, until one chunk is left, which writes every run.
// Each level cuts the sequence by kChunk / 2 (3.28 M entries: 25,600
// items, then 200, then the last level), every level is fully parallel,
// and a row's sum is a fixed tree of in-order partial sums: the result is
// the same bit for bit from run to run, whatever the skew. d_w is one
// warp an entry, a dot product reduced by a fixed butterfly.
//
// The same entry point takes a gather's transpose (seg null: entry i is
// bag i, every weight 1, sum mode): d_table[v] = sum_{i: idx[i] = v}
// g[i], the gradient of table[idx]. PyTorch's own backward of that
// indexing walks each row's duplicates with one warp, which is the hot-row
// collapse above: MIND's history gather puts about 1.9 M of 3.28 M ids on
// row 0 (the wrapper is ``gather_backward_cuda``, counted apart).
//
// Bound on this card: bytes. The dense d_table written once (V * d * 4:
// 256 MB at MIND's 1,000,000 x 64, most of the call's bytes), grad_out
// read once, and each entry's (index, segment, weight) read once; 2 L d
// operations are far below that. The kernel also gathers grad_out's row
// per entry (mostly from L2: grad_out is 16.8 MB at B = 65,536) and
// writes hot rows twice (the zeros, then the sum).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kChunk = 256;      // entries (level 1) or items (later levels) a warp sums
constexpr int kWarpsPerBlock = 8;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float v, float& out) { out = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16& out) { out = __float2bfloat16_rn(v); }

// A finished row: d_table[row][col, col + V) = acc.
template <typename T, int V>
__device__ __forceinline__ void write_row(T* __restrict__ d_table, int d, int row, int col,
                                          bool act, const float (&acc)[V]) {
  if (!act) return;
  Pack<T, V> p;
#pragma unroll
  for (int v = 0; v < V; ++v) narrow(acc[v], p.v[v]);
  *(Pack<T, V>*)(d_table + (size_t)row * d + col) = p;
}

// Item ``slot`` of this chunk: its row (lane 0) and partial sum.
template <int V>
__device__ __forceinline__ void emit(int* __restrict__ out_keys, float* __restrict__ out_vecs,
                                     int d, long long slot, int row, int col, bool act,
                                     const float (&acc)[V]) {
  if ((threadIdx.x & 31) == 0) out_keys[slot] = row;
  if (!act) return;
  Pack<float, V> p;
#pragma unroll
  for (int v = 0; v < V; ++v) p.v[v] = acc[v];
  *(Pack<float, V>*)(out_vecs + slot * d + col) = p;
}

// Each kernel below is one level: one warp a chunk [a, b) of a sequence
// sorted by row. A run ending inside the chunk, other than its first, is a
// whole row and is written; the first and the last runs become items 2c
// and 2c + 1 (a single run: itself and a zero item), or rows where this
// is the last level (one chunk).

// Level 1: the sorted entries. keys[p] is sorted entry p's row, perm[p]
// its position in the caller's arrays.
template <typename T, int V, typename ST>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    entries_kernel(const int* __restrict__ keys, const long long* __restrict__ perm,
                   const ST* __restrict__ seg, const float* __restrict__ w,
                   const float* __restrict__ cnt, const float* __restrict__ g, int d, int L,
                   int nchunks, T* __restrict__ d_table, int* __restrict__ out_keys,
                   float* __restrict__ out_vecs) {
  constexpr int U = 4;  // grad rows loaded before they are summed
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= nchunks) return;  // warp-uniform
  const int a = c * kChunk, b = min(L, a + kChunk);
  const bool final_level = nchunks == 1;
  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    const int col = c0 + lane * V;
    const bool act = col < d;  // d % V == 0: a lane's V columns are all in range or none
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    int cur = keys[a];
    bool first_run = true;
    // the next 32 entries' (row, bag, weight, count), one a lane
    int n_key = 0, n_bag = 0;
    float n_w = 1.f, n_c = 1.f;
    auto fetch = [&](int p) {
      if (p < b) {
        const long long e = perm[p];
        n_key = keys[p];
        n_bag = seg ? (int)seg[e] : (int)e;  // no segments: a gather, entry e is bag e
        n_w = w ? w[e] : 1.f;
        n_c = cnt ? cnt[n_bag] : 1.f;
      }
    };
    fetch(a + lane);
    for (int i0 = a; i0 < b; i0 += 32) {
      const int my_key = n_key, my_bag = n_bag;
      const float my_w = n_w, my_c = n_c;
      fetch(i0 + 32 + lane);
      const int n = min(32, b - i0);  // warp-uniform
      for (int t0 = 0; t0 < n; t0 += U) {
        Pack<float, V> rows[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int bag = __shfl_sync(REPRO_FULL_MASK, my_bag, (t0 + u) & 31);
          if (t0 + u < n && act) rows[u] = *(const Pack<float, V>*)(g + (size_t)bag * d + col);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int key = __shfl_sync(REPRO_FULL_MASK, my_key, (t0 + u) & 31);
          const float wt = __shfl_sync(REPRO_FULL_MASK, my_w, (t0 + u) & 31);
          const float cn = __shfl_sync(REPRO_FULL_MASK, my_c, (t0 + u) & 31);
          if (t0 + u >= n) continue;  // warp-uniform
          if (key != cur) {           // warp-uniform: a run ends
            if (first_run && !final_level)
              emit<V>(out_keys, out_vecs, d, 2LL * c, cur, col, act, acc);
            else
              write_row<T, V>(d_table, d, cur, col, act, acc);
            first_run = false;
            cur = key;
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = 0.f;
          }
          if (act) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              float t = rows[u].v[v];
              if (cnt) t = __fdiv_rn(t, cn);
              if (w) t = __fmul_rn(t, wt);
              acc[v] = __fadd_rn(acc[v], t);
            }
          }
        }
      }
    }
    if (final_level) {
      write_row<T, V>(d_table, d, cur, col, act, acc);
    } else {
      float zero[V];
#pragma unroll
      for (int v = 0; v < V; ++v) zero[v] = 0.f;
      if (first_run) {  // one run: itself and a zero item
        emit<V>(out_keys, out_vecs, d, 2LL * c, cur, col, act, acc);
        emit<V>(out_keys, out_vecs, d, 2LL * c + 1, cur, col, act, zero);
      } else {
        emit<V>(out_keys, out_vecs, d, 2LL * c + 1, cur, col, act, acc);
      }
    }
  }
}

// Later levels: n items (row, partial) sorted by row, the same rule.
template <typename T, int V>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    items_kernel(const int* __restrict__ keys, const float* __restrict__ vecs, int d, int n_items,
                 int nchunks, T* __restrict__ d_table, int* __restrict__ out_keys,
                 float* __restrict__ out_vecs) {
  constexpr int U = 4;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= nchunks) return;
  const int a = c * kChunk, b = min(n_items, a + kChunk);
  const bool final_level = nchunks == 1;
  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    const int col = c0 + lane * V;
    const bool act = col < d;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    int cur = keys[a];
    bool first_run = true;
    for (int t0 = a; t0 < b; t0 += U) {
      Pack<float, V> rows[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (t0 + u < b && act) rows[u] = *(const Pack<float, V>*)(vecs + (size_t)(t0 + u) * d + col);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t0 + u >= b) continue;  // warp-uniform
        const int key = keys[t0 + u];
        if (key != cur) {
          if (first_run && !final_level)
            emit<V>(out_keys, out_vecs, d, 2LL * c, cur, col, act, acc);
          else
            write_row<T, V>(d_table, d, cur, col, act, acc);
          first_run = false;
          cur = key;
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = 0.f;
        }
        if (act) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], rows[u].v[v]);
        }
      }
    }
    if (final_level) {
      write_row<T, V>(d_table, d, cur, col, act, acc);
    } else {
      float zero[V];
#pragma unroll
      for (int v = 0; v < V; ++v) zero[v] = 0.f;
      if (first_run) {
        emit<V>(out_keys, out_vecs, d, 2LL * c, cur, col, act, acc);
        emit<V>(out_keys, out_vecs, d, 2LL * c + 1, cur, col, act, zero);
      } else {
        emit<V>(out_keys, out_vecs, d, 2LL * c + 1, cur, col, act, acc);
      }
    }
  }
}

// d_w[i] = <table[idx[i]], gs[seg[i]]>: one warp an entry, each lane's
// columns lane, lane + 32, ... in order, then a butterfly.
template <typename T, typename IT, typename ST>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    dw_kernel(const T* __restrict__ table, const IT* __restrict__ idx, const ST* __restrict__ seg,
              const float* __restrict__ cnt, const float* __restrict__ g, int d, int L,
              float* __restrict__ d_w) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= L) return;
  const long long r = (long long)idx[i];
  const long long bg = seg ? (long long)seg[i] : i;
  const float cn = cnt ? cnt[bg] : 1.f;
  float s = 0.f;
  for (int col = lane; col < d; col += 32) {
    float gv = g[bg * d + col];
    if (cnt) gv = __fdiv_rn(gv, cn);
    s = __fadd_rn(s, __fmul_rn(widen(table[r * d + col]), gv));
  }
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(REPRO_FULL_MASK, s, o));
  if (lane == 0) d_w[i] = s;
}

template <typename T, int V, typename ST>
cudaError_t launch_levels(const int* keys, const long long* perm, const ST* seg, const float* w,
                          const float* cnt, const float* g, int d, int L, T* d_table,
                          int* keys_a, float* vecs_a, int* keys_b, float* vecs_b,
                          cudaStream_t st) {
  const int threads = 32 * kWarpsPerBlock;
  int nch = (L + kChunk - 1) / kChunk;
  entries_kernel<T, V, ST><<<(nch + kWarpsPerBlock - 1) / kWarpsPerBlock, threads, 0, st>>>(
      keys, perm, seg, w, cnt, g, d, L, nch, d_table, keys_a, vecs_a);
  cudaError_t err = cudaGetLastError();
  int* src_k = keys_a;
  float* src_v = vecs_a;
  int* dst_k = keys_b;
  float* dst_v = vecs_b;
  while (err == cudaSuccess && nch > 1) {
    const int n = 2 * nch;
    nch = (n + kChunk - 1) / kChunk;
    items_kernel<T, V><<<(nch + kWarpsPerBlock - 1) / kWarpsPerBlock, threads, 0, st>>>(
        src_k, src_v, d, n, nch, d_table, dst_k, dst_v);
    err = cudaGetLastError();
    int* tk = src_k;
    src_k = dst_k;
    dst_k = tk;
    float* tv = src_v;
    src_v = dst_v;
    dst_v = tv;
  }
  return err;
}

template <typename T, typename ST>
cudaError_t launch_v(const int* keys, const long long* perm, const ST* seg, const float* w,
                     const float* cnt, const float* g, int d, int L, T* d_table, int* keys_a,
                     float* vecs_a, int* keys_b, float* vecs_b, cudaStream_t st) {
  // the fewest columns a lane that covers d in one pass (at most 4), as the
  // width and grad_out's alignment allow
  int v = d <= 32 ? 1 : d <= 64 ? 2 : 4;
  while (v > 1 && (d % v || (uintptr_t)g % (v * sizeof(float)))) v >>= 1;
  switch (v) {
    case 4: return launch_levels<T, 4, ST>(keys, perm, seg, w, cnt, g, d, L, d_table, keys_a, vecs_a, keys_b, vecs_b, st);
    case 2: return launch_levels<T, 2, ST>(keys, perm, seg, w, cnt, g, d, L, d_table, keys_a, vecs_a, keys_b, vecs_b, st);
    default: return launch_levels<T, 1, ST>(keys, perm, seg, w, cnt, g, d, L, d_table, keys_a, vecs_a, keys_b, vecs_b, st);
  }
}

template <typename T>
cudaError_t launch_t(const void* table, const void* idx, int idx64, const int* keys,
                     const long long* perm, const void* seg, int seg64, const float* w,
                     const float* cnt, const float* g, int d, int L, void* d_table, float* d_w,
                     int* keys_a, float* vecs_a, int* keys_b, float* vecs_b, cudaStream_t st) {
  cudaError_t err =
      seg64 ? launch_v<T, long long>(keys, perm, (const long long*)seg, w, cnt, g, d, L,
                                     (T*)d_table, keys_a, vecs_a, keys_b, vecs_b, st)
            : launch_v<T, int>(keys, perm, (const int*)seg, w, cnt, g, d, L, (T*)d_table,
                               keys_a, vecs_a, keys_b, vecs_b, st);
  if (err != cudaSuccess || !d_w) return err;
  const int blocks = (L + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = 32 * kWarpsPerBlock;
  const T* tb = (const T*)table;
  if (idx64) {
    if (seg64)
      dw_kernel<T, long long, long long><<<blocks, threads, 0, st>>>(tb, (const long long*)idx, (const long long*)seg, cnt, g, d, L, d_w);
    else
      dw_kernel<T, long long, int><<<blocks, threads, 0, st>>>(tb, (const long long*)idx, (const int*)seg, cnt, g, d, L, d_w);
  } else {
    if (seg64)
      dw_kernel<T, int, long long><<<blocks, threads, 0, st>>>(tb, (const int*)idx, (const long long*)seg, cnt, g, d, L, d_w);
    else
      dw_kernel<T, int, int><<<blocks, threads, 0, st>>>(tb, (const int*)idx, (const int*)seg, cnt, g, d, L, d_w);
  }
  return cudaGetLastError();
}

}  // namespace

// table [V, d] (float32, or bfloat16 when bf16 != 0), contiguous; idx, seg
// [L] int32 (int64 where idx64 / seg64) in the caller's order, seg in
// [0, num_bags) in any order, or null for a gather's transpose (entry i
// is bag i: one entry a bag, num_bags = L); keys [L] int32 the rows idx sorted (stable),
// perm [L] int64 the position of each sorted entry; w [L] float32 or null
// (every weight 1); cnt [num_bags] float32 each bag's entry count, at
// least 1 (mean mode), or null (sum); g [num_bags, d] float32 grad_out;
// d_table [V, d] of the table's type, zero where no entry lands; d_w [L]
// float32 or null (not wanted); scratch: keys_a / vecs_a for 2 ceil(L /
// 256) items, keys_b / vecs_b for 2 ceil(that / 256).
extern "C" int bag_backward_launch(const void* table, int bf16, int d, const void* idx,
                                   int idx64, const int* keys, const long long* perm,
                                   const void* seg, int seg64, const float* w,
                                   const float* cnt, const float* g, int L, void* d_table,
                                   float* d_w, int* keys_a, float* vecs_a, int* keys_b,
                                   float* vecs_b, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return (int)launch_t<__nv_bfloat16>(table, idx, idx64, keys, perm, seg, seg64, w, cnt, g, d,
                                        L, d_table, d_w, keys_a, vecs_a, keys_b, vecs_b, st);
  return (int)launch_t<float>(table, idx, idx64, keys, perm, seg, seg64, w, cnt, g, d, L,
                              d_table, d_w, keys_a, vecs_a, keys_b, vecs_b, st);
}
