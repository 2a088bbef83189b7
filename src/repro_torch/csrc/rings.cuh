// Scoring of routed ring-buffer entries and the per-query top-k over
// them, shared by the serve kernel (after its fused route) and the rerank
// kernel (routes given), so the two score every entry with the same
// arithmetic and pick with the same selection: the staged query equals the
// fused one by construction.
//
// Candidate c = p * depth + s is slot s of the query's p-th route; a ring
// is read by pointer arithmetic over the given element strides, so a
// depth-clipped view embs[:, :depth] is read in place and never copied.
// A slot is live where its document id is >= 0 (the store's own rule,
// docstore.live_mask): the kernels read the ids view, so no mask is built.
//
// A query's nprobe * depth candidates are split over a cluster of CS
// blocks of 256 threads (CS = 1, 2, 4 or 8, chosen by the wrapper so that
// Q * CS blocks cover the card). Each block scores its contiguous share:
// - 16-byte path, where d is a multiple of a 16-byte chunk (16 int8 or 4
//   fp32 values) and the ring pointer and strides are 16-byte aligned: a
//   group of G lanes scores a row (G the power of two with d <= 64 G), each
//   lane holding its <= 64 query components in registers and loading its
//   chunks of the row 16 bytes at a time (the G lanes of a group read
//   neighbouring chunks); a group has 4 int8 rows (one fp32 row) in flight
//   at once, int8 values widen by a byte
//   permute and an add (dot_chunk), and the row ends in log2(G) shuffles;
// - scalar path otherwise: a warp per row, lanes strided along d, 4-byte
//   or 1-byte loads, one warp sum.
// A score is (q . e) * scale in fp32 (the dot first, then the int8 slot's
// scale; fp32 rings carry none), NEG_INF where the slot's id is -1 or the
// route is -1, turned into keys.cuh's composite key (ordered score bits,
// then 0xFFFFFFFF - c): one unsigned order that is "larger score, then
// lower position", with no two keys equal.
// Top-k: each warp takes the k largest keys of a contiguous part of the
// block's keys by k rounds of a warp max (no barrier), then every one of
// those warps' keys is ranked against the others (block_topk_keys). In a
// cluster, each block sends its k keys into the leader's shared memory
// (distributed shared memory), and the leader ranks the CS lists and
// hands each of the k picks to the caller's epilogue (ring_topk's emit).
//
// Bound on this card: bytes, each distinct routed ring read once (25 KB an
// int8 ring of depth 64 at d = 384; up to 12.6 MB, 3.8 us, when 64
// queries' 8 routes are all distinct). On an H100 80GB HBM3 at 700 W the
// ring code takes about 0.012 ms as rerank and 0.015 as serve's second
// launch (tools/kernel_ab.py; PERF.md).
#pragma once

#include <cooperative_groups.h>

#include "keys.cuh"

namespace cg = cooperative_groups;

constexpr int kRingThreads = 256;
constexpr int kRingWarps = kRingThreads / 32;
constexpr int kLaneElems = 64;     // query components a lane holds on the 16-byte path
constexpr int kInt8RowsInFlight = 4;
constexpr int kMaxCluster = 8;     // the portable cluster size

// The ring tensors [C, depth, d] (int8 with scales, or fp32) as element
// pointers and strides; ids (int32 document ids, -1 = empty slot) and
// scales are [C, depth].
struct RingView {
  const void* embs;
  long long es0, es1;
  const int* ids;
  long long is0, is1;
  const float* scales;
  long long ss0, ss1;
  int quantized, depth;
};

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Byte offsets of one block's shared memory (m route keys for serve, 0
// for rerank). The key arrays come first, so every one is 8-byte aligned.
struct RingSmem {
  int cand, lst, gather, rk, rlst, sq, sroutes, bytes;
};

__host__ __device__ __forceinline__ int ring_share(int ncand, int cs) {
  return (ncand + cs - 1) / cs;  // the most candidates one block of a cluster scores
}

__host__ __device__ __forceinline__ int warp_keep(int n, int k) {
  return imin(k, (n + kRingWarps - 1) / kRingWarps);  // keys a warp keeps of n
}

__host__ __device__ __forceinline__ RingSmem ring_smem(int d, int nprobe, int depth, int k,
                                                      int cs, int m) {
  const int nmax = ring_share(nprobe * depth, cs);
  RingSmem s;
  int o = 0;
  s.cand = o;
  o += nmax * 8;
  s.lst = o;
  o += kRingWarps * warp_keep(nmax, k) * 8;
  s.gather = o;
  o += (cs > 1 ? cs * imin(k, nmax) : 0) * 8;
  s.rk = o;
  o += m * 8;
  s.rlst = o;
  o += (m ? kRingWarps * warp_keep(m, nprobe) : 0) * 8;
  s.sq = o;
  o += d * 4;
  s.sroutes = o;
  o += nprobe * 4;
  s.bytes = o;
  return s;
}

// Lanes per row on the 16-byte path, or 0 for the scalar path.
static int ring_lanes(int d, int quantized, const void* embs, long long es0, long long es1) {
  const int esize = quantized ? 1 : 4, w = 16 / esize;
  if (d % w || d > 32 * kLaneElems || (uintptr_t)embs % 16 || (es0 * esize) % 16 ||
      (es1 * esize) % 16)
    return 0;
  int g = 1;
  while (g * kLaneElems < d) g <<= 1;
  return g;
}

// acc + q . (the 16-byte chunk v of a row), components in order. An int8
// value widens without the quarter-rate integer-to-float conversion: the
// byte, flipped to value + 128, becomes the low mantissa byte of 2^23
// (0x4B000000) by one byte permute, and 2^23 + 128 comes off by one add;
// both steps are exact, so the value is the conversion's.
__device__ __forceinline__ float dot_chunk(const float* q, uint4 v, float acc, signed char) {
  const unsigned w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const float e =
        __uint_as_float(__byte_perm(w[b >> 2], 0x4B000000u, 0x7540u | (b & 3))) - 8388736.0f;
    acc = fmaf(q[b], e, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot_chunk(const float* q, uint4 v, float acc, float) {
  acc = fmaf(q[0], __uint_as_float(v.x), acc);
  acc = fmaf(q[1], __uint_as_float(v.y), acc);
  acc = fmaf(q[2], __uint_as_float(v.z), acc);
  return fmaf(q[3], __uint_as_float(v.w), acc);
}

__device__ __forceinline__ key64 entry_key(float acc, bool ok, float scale, int quantized,
                                           int c) {
  const float v = ok ? (quantized ? acc * scale : acc) : REPRO_NEG_INF;
  return make_key(ordered_bits(v), (unsigned)c);
}

// cand[c] = the key of candidate c0 + c, for c < n; G lanes a row.
template <typename T>
__device__ void score_rows_vec(const float* sq, int d, int G, const int* sroutes,
                               const RingView& rv, int c0, int n, key64* cand) {
  constexpr int W = 16 / sizeof(T);         // components per 16-byte chunk
  constexpr int CPL = kLaneElems / W;       // chunks a lane may hold
  constexpr int R = sizeof(T) == 1 ? kInt8RowsInFlight : 1;
  const int gl = threadIdx.x & (G - 1), grp = threadIdx.x / G, ng = blockDim.x / G;
  const int chunks = d / W;
  float qs[CPL][W];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int ch = gl + G * j;
#pragma unroll
    for (int e = 0; e < W; ++e) qs[j][e] = ch < chunks ? sq[ch * W + e] : 0.f;
  }
  const T* embs = (const T*)rv.embs;
  const int iters = (n + ng * R - 1) / (ng * R);  // the same for every lane
  for (int it = 0; it < iters; ++it) {
    uint4 raw[R][CPL];
    bool ok[R];
    float scale[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int c = (it * R + u) * ng + grp;
      int route = -1, s = 0;
      if (c < n) {
        const int p = (c0 + c) / rv.depth;
        s = c0 + c - p * rv.depth;
        route = sroutes[p];
      }
      const T* row = embs + route * rv.es0 + s * rv.es1;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int ch = gl + G * j;
        raw[u][j] = (route >= 0 && ch < chunks) ? __ldg((const uint4*)(row + ch * W))
                                                : make_uint4(0u, 0u, 0u, 0u);
      }
      ok[u] = route >= 0 && rv.ids[route * rv.is0 + s * rv.is1] >= 0;
      scale[u] = (route >= 0 && rv.quantized) ? rv.scales[route * rv.ss0 + s * rv.ss1] : 1.f;
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc = dot_chunk(qs[j], raw[u][j], acc, T());
      for (int o = G >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(REPRO_FULL_MASK, acc, o);
      const int c = (it * R + u) * ng + grp;
      if (gl == 0 && c < n) cand[c] = entry_key(acc, ok[u], scale[u], rv.quantized, c0 + c);
    }
  }
}

// The same keys, a warp a row (any d, any alignment).
template <typename T>
__device__ void score_rows_scalar(const float* sq, int d, const int* sroutes,
                                  const RingView& rv, int c0, int n, key64* cand) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int c = warp; c < n; c += nw) {
    const int p = (c0 + c) / rv.depth, s = c0 + c - p * rv.depth;
    const int route = sroutes[p];
    float acc = 0.f;
    if (route >= 0) {
      const T* e = (const T*)rv.embs + route * rv.es0 + s * rv.es1;
      for (int t = lane; t < d; t += 32) acc = fmaf(sq[t], (float)e[t], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const bool ok = route >= 0 && rv.ids[route * rv.is0 + s * rv.is1] >= 0;
      const float scale = (ok && rv.quantized) ? rv.scales[route * rv.ss0 + s * rv.ss1] : 1.f;
      cand[c] = entry_key(acc, ok, scale, rv.quantized, c0 + c);
    }
  }
}

// emit(rank, key) for each non-zero key of buf[0, n) whose rank (the
// number of larger keys) is below k; the non-zero keys are unique.
template <typename Emit>
__device__ void rank_emit_nonzero(const key64* buf, int n, int k, Emit emit) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const key64 mine = buf[i];
    if (!mine) continue;
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += buf[j] > mine;
    if (rank < k) emit(rank, mine);
  }
}

// The min(k, n) largest of the unique non-zero keys cand[0, n) of the
// block, through emit(rank, key). Each warp keeps the k largest of its
// contiguous part of cand by rounds of a warp max below the last pick, in
// lst [kRingWarps * warp_keep(n, k)] (0 past a short part); then every key
// of lst is ranked against the others. Every thread calls it, after a
// barrier that made cand visible; it ends with a barrier.
template <typename Emit>
__device__ void block_topk_keys(const key64* cand, int n, int k, key64* lst, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kw = warp_keep(n, k);
  const int lo = (int)((long long)n * warp / kRingWarps);
  const int hi = (int)((long long)n * (warp + 1) / kRingWarps);
  key64 last = ~0ull;
  for (int r = 0; r < kw; ++r) {
    key64 m = 0;
    for (int i = lo + lane; i < hi; i += 32) {
      const key64 x = cand[i];
      if (x < last && x > m) m = x;
    }
    for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(REPRO_FULL_MASK, m, o));
    last = m;
    if (lane == 0) lst[warp * kw + r] = m;
  }
  __syncthreads();
  rank_emit_nonzero(lst, kRingWarps * kw, k, emit);
  __syncthreads();
}

// Cluster bookkeeping at a ring kernel's start: the leader zeroes the list
// its peers will fill, then every block arrives on the cluster barrier;
// ring_topk waits on it before it touches another block's memory.
__device__ __forceinline__ void ring_cluster_start(unsigned char* smem, const RingSmem& L,
                                                   int nprobe, int depth, int k) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  if (cs == 1) return;
  if (cluster.block_rank() == 0) {
    key64* gather = (key64*)(smem + L.gather);
    const int n = cs * imin(k, ring_share(nprobe * depth, cs));
    for (int i = threadIdx.x; i < n; i += blockDim.x) gather[i] = 0;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// A pick's position: its candidate, -1 where its score is dead.
__device__ __forceinline__ int pick_pos(key64 key) {
  return key_score(key) > REPRO_NEG_INF / 2 ? key_row(key) : -1;
}

// One query's top-k over its routed rings (sroutes [nprobe] and the query
// sq [d] in shared memory, visible to every thread): this block's share of
// the candidates is scored and cut to its k best; in a cluster the leader
// merges the blocks' lists. The leader (or the lone block) calls emit(t,
// key) for the t-th pick, t < k (key_score and pick_pos read it), where
// sroutes is its own. k <= nprobe * depth.
template <typename Emit>
__device__ void ring_topk(unsigned char* smem, const RingSmem& L, const float* sq, int d,
                          int G, const int* sroutes, int nprobe, const RingView& rv, int k,
                          Emit emit) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int ncand = nprobe * rv.depth;
  const int c0 = (int)((long long)ncand * rank / cs);
  const int n = (int)((long long)ncand * (rank + 1) / cs) - c0;
  key64* cand = (key64*)(smem + L.cand);
  key64* lst = (key64*)(smem + L.lst);
  if (G == 0)
    rv.quantized ? score_rows_scalar<signed char>(sq, d, sroutes, rv, c0, n, cand)
                 : score_rows_scalar<float>(sq, d, sroutes, rv, c0, n, cand);
  else
    rv.quantized ? score_rows_vec<signed char>(sq, d, G, sroutes, rv, c0, n, cand)
                 : score_rows_vec<float>(sq, d, G, sroutes, rv, c0, n, cand);
  __syncthreads();
  if (cs == 1) {
    block_topk_keys(cand, n, k, lst, emit);
    return;
  }
  const int kl = imin(k, ring_share(ncand, cs));
  key64* dst = cluster.map_shared_rank((key64*)(smem + L.gather), 0) + rank * kl;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");  // all blocks started
  block_topk_keys(cand, n, k, lst, [&](int t, key64 key) { dst[t] = key; });
  cluster.sync();  // every list is in the leader's shared memory
  if (rank == 0) rank_emit_nonzero((const key64*)(smem + L.gather), cs * kl, k, emit);
}

// Waits until the kernel before this one on the stream has finished and its
// writes are visible (Hopper's programmatic dependent launch: launch_ring
// lets a ring kernel's blocks start while that kernel still runs). A ring
// kernel calls it before it reads what an earlier kernel wrote and before
// it writes to device memory.
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launches a ring kernel as Q clusters of cs blocks (cs = 1 is a plain
// launch of Q blocks), allowed to start before the previous kernel on the
// stream has finished (it calls wait_for_previous_kernel): its launch and
// set-up overlap that kernel's tail.
template <typename... Params, typename... Args>
static cudaError_t launch_ring(void (*kernel)(Params...), int Q, int cs, size_t smem,
                               cudaStream_t st, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(Q * cs));
  cfg.blockDim = dim3(kRingThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}
