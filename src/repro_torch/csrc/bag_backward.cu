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
// bf16), rows no entry touches exactly zero.
//
// The same entry point takes a gather's transpose (seg null: entry i is
// bag i, every weight 1, sum mode): d_table[v] = sum_{i: idx[i] = v}
// g[i], the gradient of table[idx]. PyTorch's own backward of that
// indexing walks each row's duplicates with one warp, which collapses on
// MIND's padding row 0 (about 1.9 M of a history gather's 3.28 M ids).
//
// The hard part is skew. MIND's profile bag sends every masked history
// position to row 0 with weight 0, and row 0 is also the Zipf head: about
// 2 M of a train batch's 3.28 M entries land on one row, and a batch of
// dummy ids sends all of them there. A design that serialises on a row
// (one warp walking a row's entries, or an f32 atomicAdd from every entry
// onto one row's addresses) collapses there, and float atomics would also
// make the sum's order change from run to run.
//
// Bound on this card: bytes. The dense d_table written once (V * d * 4:
// 256 MB at MIND's 10^6 x 64), grad_out read once (16.8 MB for the bag,
// 839 MB for the history gather) and each entry's (index, segment, weight)
// read once; 2 L d operations are far below that.
//
// Design, all of it deterministic (no float atomics; integer atomics only
// count a bag's entries), every row of d_table written exactly once and
// no zero fill:
//
// 1. A stable LSD radix sort of the entries by row, written here: only
//    the ceil(log2 V) bits a row id has, in passes of at most 11 bits the
//    wrapper plans (2 at V = 10^6, 3 for any V below 2^31). The first
//    pass counts each tile's digits; every pass scans the tile counts
//    (one block per 32 digits) and scatters: it ranks an entry within
//    its warp's strip of the tile (a warp's equal digits found with one
//    ballot a bit, counted with one shared atomic a digit), reorders the
//    tile in shared memory and writes it out digit by digit, so the writes
//    coalesce. Each scatter also counts the next pass's tile digits as it
//    places the entries, and the last one marks the rows it places as
//    touched. A batch with every entry on row 0 costs no more than any
//    other. The payload is the entry's bag and weight (a gather: its
//    position), carried through the passes, so no later step reads seg,
//    w or a permutation at random. In mean mode the first histogram also
//    counts each bag's entries, and grad_out is divided by the counts
//    once a bag.
// 2. One warp a chunk of kChunk sorted entries records where the rows
//    that start in it start and sums the chunk in order, the chunk's
//    keys, bags and weights loaded at once and a batch of rows of
//    grad_out in flight. A row that lies wholly in the chunk is written to
//    d_table there; the chunk's first and last runs, where their row goes
//    on into the neighbouring chunk, become pieces (slot 2c, 2c + 1).
// 3. One warp a group of kGroup chunks that a single row fills sums their
//    pieces in chunk order (the second level a long row needs).
// 4. One warp a chunk where a spanning row ends writes that row: its
//    pieces in chunk order, a filled group's level-2 sum in place of its
//    kGroup pieces. No row serialises: the longest, MIND's row 0 with ~2 M
//    entries, is ~250 partial sums.
// 5. The dense pass writes every untouched row as zeros, in row order, 32
//    rows a warp at a time.
// Each row's sum is a fixed sequence of in-order partial sums, the same
// bits call after call whatever the skew. d_w is one warp an entry, a dot
// product reduced by a fixed butterfly.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                  // warps a block, every kernel here
constexpr int kThreads = 32 * kWarps;
constexpr int kItems = 16;                 // entries a lane ranks in a sort pass
constexpr int kStrip = 32 * kItems;        // a warp's strip of a sort tile
constexpr int kTile = kWarps * kStrip;     // 4096 entries a sort block
constexpr int kChunk = 256;                // sorted entries a warp sums into a piece
constexpr int kGroup = 64;                 // chunks a level-2 sum covers
constexpr int kMaxPasses = 3;              // 3 x 11 bits cover any V below 2^31
constexpr int kMaxRadix = 1 << 11;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float v, float& out) { out = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16& out) { out = __float2bfloat16_rn(v); }

// rows a warp keeps in flight while it sums (4 KB at 2 and 4 columns a lane)
template <int V>
constexpr int kInFlight = V == 4 ? 8 : 16;

// ------------------------------------------------------------------ sort
// An entry as the first pass reads it: the caller's arrays (its row, its
// bag: seg[i], or i for a gather, and its weight).
template <typename IT, typename ST>
struct CallerEntries {
  const IT* idx;
  const ST* seg;
  const float* w;
  __device__ __forceinline__ int key(int i) const { return (int)idx[i]; }
  __device__ __forceinline__ int bag(int i) const { return seg ? (int)seg[i] : i; }
  __device__ __forceinline__ float weight(int i) const { return w[i]; }
};

// An entry as a later pass reads it: the previous pass's output.
struct SortedEntries {
  const int* keys;
  const int* bags;
  const float* w;
  __device__ __forceinline__ int key(int i) const { return keys[i]; }
  __device__ __forceinline__ int bag(int i) const { return bags[i]; }
  __device__ __forceinline__ float weight(int i) const { return w[i]; }
};

// Exclusive prefix sum of v over the block; total gets the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(REPRO_FULL_MASK, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[wid] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int s = warp_sums[k];
    if (k < wid) before += s;
    total += s;
  }
  __syncthreads();  // warp_sums free for the next call
  return before + inc - v;
}

// The lanes (among all 32) whose digit equals this lane's, among the
// lanes with the same `ok`: one ballot a bit (a warp-wide match without
// __match_any_sync, whose throughput is far lower).
__device__ __forceinline__ unsigned same_digit(unsigned dg, bool ok) {
  unsigned peers = __ballot_sync(REPRO_FULL_MASK, ok);
  if (!ok) peers = ~peers;
#pragma unroll
  for (int b = 0; b < 11; ++b) {  // kMaxRadix's bits; a digit's bits past its width are 0
    const unsigned set = __ballot_sync(REPRO_FULL_MASK, (dg >> b) & 1u);
    peers &= (dg >> b) & 1u ? set : ~set;
  }
  return peers;
}

// The lowest lane of a group of peers adds for the whole group.
__device__ __forceinline__ bool group_leader(unsigned peers) {
  return (int)(threadIdx.x & 31) == __ffs(peers) - 1;
}

// counts[tile * radix + digit] = entries of this tile with that digit;
// with cnt (mean mode, first pass), cnt[bag] += the tile's entries of it,
// one atomic a run of equal bags among a warp's 32 consecutive entries.
template <class Src>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(Src src, int L, int shift, int bits, int ntiles, int* __restrict__ counts,
                int* __restrict__ cnt) {
  extern __shared__ int hist[];
  const int radix = 1 << bits, lane = threadIdx.x & 31;
  for (int r = threadIdx.x; r < radix; r += kThreads) hist[r] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  int key[kItems], bag[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {  // every load first, all in flight together
    const int i = base + j * kThreads + threadIdx.x;
    key[j] = i < L ? src.key(i) : 0;
    bag[j] = cnt && i < L ? src.bag(i) : -1;
  }
  unsigned peers[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j)  // every ballot first, with no branch between
    peers[j] = same_digit((key[j] >> shift) & (radix - 1),
                          base + j * kThreads + (int)threadIdx.x < L);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (base + j * kThreads + (int)threadIdx.x < L && group_leader(peers[j]))
      atomicAdd(&hist[(key[j] >> shift) & (radix - 1)], __popc(peers[j]));
  }
  if (cnt) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {  // the runs of equal bags, by their first lanes
      const int up = __shfl_up_sync(REPRO_FULL_MASK, bag[j], 1);
      peers[j] = __ballot_sync(REPRO_FULL_MASK, lane == 0 || up != bag[j]);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (base + j * kThreads + (int)threadIdx.x < L && (peers[j] >> lane & 1u)) {
        const unsigned later = lane == 31 ? 0u : peers[j] & (~0u << (lane + 1));
        atomicAdd(cnt + bag[j], (later ? __ffs(later) - 1 : 32) - lane);
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < radix; r += kThreads)
    counts[(size_t)blockIdx.x * radix + r] = hist[r];
}

// One block 32 digits, a lane each: a digit's tile counts become their
// exclusive prefix over tiles, and totals[digit] its entries. Warp k of
// kScanWarps takes the k-th share of the tiles, reading 32 digits of a
// tile at once.
constexpr int kScanWarps = 32;
__global__ void __launch_bounds__(32 * kScanWarps)
    scan_kernel(int* __restrict__ counts, int ntiles, int radix, int* __restrict__ totals) {
  __shared__ int part[kScanWarps][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int r = blockIdx.x * 32 + lane;
  const bool ok = r < radix;
  const int per = (ntiles + kScanWarps - 1) / kScanWarps;
  const int t0 = min(ntiles, wid * per), t1 = min(ntiles, t0 + per);
  int s = 0;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) s += ok ? counts[(size_t)t * radix + r] : 0;
  part[wid][lane] = s;
  __syncthreads();
  int run = 0, total = 0;
  for (int k = 0; k < kScanWarps; ++k) {
    if (k < wid) run += part[k][lane];
    total += part[k][lane];
  }
  if (!ok) return;
  for (int t = t0; t < t1; ++t) {
    const int c = counts[(size_t)t * radix + r];
    counts[(size_t)t * radix + r] = run;
    run += c;
  }
  if (wid == 0) totals[r] = total;
}

// The stable scatter of one tile: warp k's strip holds the tile's entries
// [k kStrip, (k + 1) kStrip), so an entry's rank among the tile's entries
// of its digit is the entries of it in earlier warps' strips plus the
// lanes before it with that digit in its round. The tile is first
// reordered by (digit, rank) in shared memory, then written out in that
// order: a digit's entries of the tile land in consecutive places, so the
// writes coalesce.
template <class Src>
__global__ void __launch_bounds__(kThreads, 2)
    scatter_kernel(Src src, int L, int shift, int bits, int ntiles,
                   const int* __restrict__ counts, const int* __restrict__ totals,
                   int* __restrict__ keys_out, int* __restrict__ bags_out,
                   float* __restrict__ w_out, int next_shift, int next_bits,
                   int* __restrict__ next_counts, unsigned char* __restrict__ touched) {
  extern __shared__ int smem[];
  const int radix = 1 << bits;
  int* next_pos = smem;                    // [kWarps][radix]: a warp's next tile place for a digit
  int* shift_to = next_pos + kWarps * radix;  // [radix]: global place - tile place, for a digit
  int* st_key = shift_to + radix;          // [kTile] the tile, reordered
  int* st_bag = st_key + kTile;
  float* st_w = (float*)(st_bag + kTile);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int tile0 = blockIdx.x * kTile, n_tile = min(kTile, L - tile0);
  const int strip = tile0 + wid * kStrip;
  int* mine = next_pos + wid * radix;
  for (int r = lane; r < radix; r += 32) mine[r] = 0;
  __syncwarp();
  int key[kItems], bag[kItems];
  float wt[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {  // every load first, all in flight together
    const int i = strip + j * 32 + lane;
    const bool valid = i < L;
    key[j] = valid ? src.key(i) : 0;
    bag[j] = valid ? src.bag(i) : 0;
    wt[j] = valid && w_out ? src.weight(i) : 1.f;
  }
  // each entry's digit peers in its round, then (leaders, in round order)
  // the strip's count of the digit before the round, then that count on
  // every lane: with no branch between the ballots or between the shuffles
  unsigned peers[kItems];
  int before[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    peers[j] = same_digit((key[j] >> shift) & (radix - 1), strip + j * 32 + lane < L);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    before[j] = 0;
    if (strip + j * 32 + lane < L && group_leader(peers[j]))
      before[j] = atomicAdd(&mine[(key[j] >> shift) & (radix - 1)], __popc(peers[j]));
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    before[j] = __shfl_sync(REPRO_FULL_MASK, before[j], __ffs(peers[j]) - 1);
  __syncthreads();
  // each thread owns `per` consecutive digits: their start over all tiles
  // (a scan of the totals) and within this tile (a scan of its counts)
  const int per = (radix + kThreads - 1) / kThreads;
  const int d0 = min(radix, (int)threadIdx.x * per), d1 = min(radix, d0 + per);
  const int* tile_counts = counts + (size_t)blockIdx.x * radix;  // prefix over earlier tiles
  int s_all = 0, s_tile = 0;
  for (int r = d0; r < d1; ++r) {
    s_all += totals[r];
    for (int k = 0; k < kWarps; ++k) s_tile += next_pos[k * radix + r];
  }
  int sum;
  int start = block_exclusive_scan(s_all, sum);
  int local = block_exclusive_scan(s_tile, sum);
  for (int r = d0; r < d1; ++r) {
    shift_to[r] = start + tile_counts[r] - local;
    start += totals[r];
    for (int k = 0; k < kWarps; ++k) {
      const int c = next_pos[k * radix + r];
      next_pos[k * radix + r] = local;
      local += c;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (strip + j * 32 + lane < L) {
      const int at = mine[(key[j] >> shift) & (radix - 1)] + before[j] + __popc(peers[j] & below);
      st_key[at] = key[j];
      st_bag[at] = bag[j];
      st_w[at] = wt[j];
    }
  }
  __syncthreads();
  const int next_radix = 1 << next_bits;
  for (int at0 = 0; at0 < kTile; at0 += kThreads) {  // block-uniform trip count
    const int at = at0 + threadIdx.x;
    const bool valid = at < n_tile;
    const int k = valid ? st_key[at] : -1;
    const int pos = valid ? at + shift_to[(k >> shift) & (radix - 1)] : -1;
    if (valid) {
      keys_out[pos] = k;
      bags_out[pos] = st_bag[at];
      if (w_out) w_out[pos] = st_w[at];
      // the last pass marks each row it places as touched, once a tile
      if (touched && (at == 0 || st_key[at - 1] != k)) touched[k] = 1;
    }
    if (next_counts) {  // the next pass's tile counts, one atomic a run of equal (tile, digit)
      const int cell = valid ? (pos / kTile) * next_radix + ((k >> next_shift) & (next_radix - 1))
                             : -1;
      const int up = __shfl_up_sync(REPRO_FULL_MASK, cell, 1);
      const unsigned heads = __ballot_sync(REPRO_FULL_MASK, lane == 0 || up != cell);
      if (valid && (heads >> lane & 1u)) {
        const unsigned later = lane == 31 ? 0u : heads & (~0u << (lane + 1));
        atomicAdd(next_counts + cell, (later ? __ffs(later) - 1 : 32) - lane);
      }
    }
  }
}

// One pass: the tile counts (the first pass's own histogram; later
// passes' were filled by the pass before), their scan, the scatter, which
// fills next_counts for the pass after it or, in the last pass, marks the
// touched rows.
template <class Src>
cudaError_t sort_pass(Src src, int L, int shift, int width, int next_width, int ntiles,
                      int* counts, int* next_counts, int* totals, int* cnt, bool first,
                      int* keys_out, int* bags_out, float* w_out, unsigned char* touched,
                      cudaStream_t st) {
  const int radix = 1 << width;
  cudaError_t err = cudaSuccess;
  if (first) {
    hist_kernel<Src><<<ntiles, kThreads, radix * sizeof(int), st>>>(src, L, shift, width,
                                                                    ntiles, counts, cnt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  scan_kernel<<<(radix + 31) / 32, 32 * kScanWarps, 0, st>>>(counts, ntiles, radix, totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (next_counts &&
      (err = cudaMemsetAsync(next_counts, 0, sizeof(int) * ((size_t)ntiles << next_width), st)) !=
          cudaSuccess)
    return err;
  const size_t smem = ((size_t)(kWarps + 1) * radix + 3 * kTile) * sizeof(int);
  if ((err = allow_smem(scatter_kernel<Src>, smem)) != cudaSuccess) return err;
  scatter_kernel<Src><<<ntiles, kThreads, smem, st>>>(
      src, L, shift, width, ntiles, counts, totals, keys_out, bags_out, w_out, shift + width,
      next_width, next_counts, next_counts ? nullptr : touched);
  return cudaGetLastError();
}

// ------------------------------------------------------------- the sums
template <typename T, int V>
__device__ __forceinline__ void store_row(T* __restrict__ out, const float (&acc)[V]) {
  Pack<T, V> p;
#pragma unroll
  for (int v = 0; v < V; ++v) narrow(acc[v], p.v[v]);
  *(Pack<T, V>*)out = p;
}

// The end of the run of `row` that starts at sorted position a, within
// [a, b): the first position whose key differs, or b.
__device__ __forceinline__ int run_end(const int* __restrict__ keys, int row, int a, int b) {
  for (int p0 = a; p0 < b; p0 += 32) {
    const int p = p0 + (int)(threadIdx.x & 31);
    const unsigned other = __ballot_sync(REPRO_FULL_MASK, p < b && keys[p] != row);
    if (other) return p0 + __ffs(other) - 1;
  }
  return b;
}

// Step 2: one warp a chunk [a, b) of the sorted entries. It records where
// each row that starts in the chunk starts, then sums the chunk in sorted
// order, each entry its bag's row of gs times its weight, kInFlight rows
// in flight a warp. A run whose row lies wholly in the chunk is that
// row's sum and is written to d_table; the first and the last run, where
// the row goes on into the neighbouring chunk, become pieces: slot 2c for
// the first run, 2c + 1 for the last.
template <typename T, int V, bool HAS_W>
__global__ void __launch_bounds__(kThreads, 2)
    chunk_kernel(const int* __restrict__ keys, const int* __restrict__ bags,
                 const float* __restrict__ w, const float* __restrict__ gs, int d, int L,
                 int nchunks, int* __restrict__ row_start, float* __restrict__ pieces,
                 T* __restrict__ d_table) {
  constexpr int U = kInFlight<V>;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= nchunks) return;  // warp-uniform
  const int a = c * kChunk, b = min(L, a + kChunk);
  // the whole chunk's keys, bags and weights first, all in flight
  // together: lane l holds entries a + 32 j + l
  constexpr int J = kChunk / 32;
  int pk[J], pb[J];
  float pw[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int p = a + j * 32 + lane;
    pk[j] = p < b ? keys[p] : -1;
    pb[j] = p < b ? bags[p] : 0;
    pw[j] = HAS_W && p < b ? w[p] : 1.f;
  }
  const int before = a > 0 ? keys[a - 1] : -1, after = b < L ? keys[b] : -1;
  // the row of each entry's predecessor in the sorted order
  int up[J], tail[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    up[j] = __shfl_up_sync(REPRO_FULL_MASK, pk[j], 1);
    tail[j] = __shfl_sync(REPRO_FULL_MASK, pk[j], 31);
  }
  const int first = __shfl_sync(REPRO_FULL_MASK, pk[0], 0);
  const int nb = b - a - 1;  // the chunk's last entry, as (nb / 32, nb % 32)
  int last = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = __shfl_sync(REPRO_FULL_MASK, pk[j], nb & 31);
    if (j == nb / 32) last = k;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int prev = lane > 0 ? up[j] : j > 0 ? tail[j - 1] : before;
    if (pk[j] >= 0 && pk[j] != prev) row_start[pk[j]] = a + j * 32 + lane;  // a row starts here
  }
  const bool one_run = first == last;
  const bool span_first = before == first || (one_run && after == first);
  const bool span_last = !one_run && after == last;
  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    const int col = c0 + lane * V;
    const bool act = col < d;  // d % V == 0: a lane's V columns are all in range or none
    float acc[V] = {};
    int row = first;
    bool first_run = true;
    // the finished run of `row`: a piece where it spans chunks, else its row of d_table
    auto emit = [&](bool last_run) {
      if (act) {
        if (first_run && span_first)
          store_row<float, V>(pieces + 2LL * c * d + col, acc);
        else if (last_run && span_last)
          store_row<float, V>(pieces + (2LL * c + 1) * d + col, acc);
        else
          store_row<T, V>(d_table + (long long)row * d + col, acc);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
    };
    for (int jb = 0; a + 32 * jb < b; ++jb) {
      const int n = min(32, b - a - 32 * jb);  // warp-uniform
      int mk = pk[0], mb = pb[0];  // batch jb's payload
      float mw = pw[0];
#pragma unroll
      for (int j = 1; j < J; ++j) {
        if (j == jb) {
          mk = pk[j];
          mb = pb[j];
          mw = pw[j];
        }
      }
      // the batch's entries that start a run (lane 0: against the run so far)
      const int upk = __shfl_up_sync(REPRO_FULL_MASK, mk, 1);
      const unsigned starts = __ballot_sync(REPRO_FULL_MASK, mk != (lane == 0 ? row : upk));
#pragma unroll
      for (int t0 = 0; t0 < 32; t0 += U) {
        if (t0 >= n) break;  // warp-uniform
        // every shuffle and row load of the U entries first, with no branch
        // between them: a shuffle cannot move past a branch, so one inside
        // the summing loop would put its latency on every entry
        Pack<float, V> rows[U];
        float wt[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int bg = __shfl_sync(REPRO_FULL_MASK, mb, t0 + u);
          if (HAS_W) wt[u] = __shfl_sync(REPRO_FULL_MASK, mw, t0 + u);
          if (act) rows[u] = *(const Pack<float, V>*)(gs + (size_t)bg * d + col);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (t0 + u >= n) break;          // warp-uniform
          if (starts >> (t0 + u) & 1u) {   // warp-uniform: a run ends, the next begins
            emit(false);
            first_run = false;
            row = __shfl_sync(REPRO_FULL_MASK, mk, t0 + u);
          }
          if (act) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              float t = rows[u].v[v];
              if (HAS_W) t = __fmul_rn(t, wt[u]);
              acc[v] = __fadd_rn(acc[v], t);
            }
          }
        }
      }
    }
    emit(true);
  }
}

// Step 3: one warp a group of kGroup chunks; where one row fills the
// group, level2[group] = its pieces summed in chunk order.
template <int V>
__global__ void __launch_bounds__(kThreads)
    group_kernel(const int* __restrict__ keys, const float* __restrict__ pieces, int d,
                 int ngroups, float* __restrict__ level2) {
  constexpr int U = kInFlight<V>;
  const int lane = threadIdx.x & 31;
  const int gi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gi >= ngroups) return;
  const long long a = (long long)gi * kGroup * kChunk;
  if (keys[a] != keys[a + (long long)kGroup * kChunk - 1]) return;  // warp-uniform
  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    const int col = c0 + lane * V;
    const bool act = col < d;
    float acc[V] = {};
    for (int k0 = 0; k0 < kGroup; k0 += U) {
      Pack<float, V> rows[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (act)
          rows[u] = *(const Pack<float, V>*)(pieces + 2LL * ((long long)gi * kGroup + k0 + u) * d + col);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (act) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], rows[u].v[v]);
        }
    }
    if (act) store_row<float, V>(level2 + (long long)gi * d + col, acc);
  }
}

// Step 4: one warp a chunk whose first run ends a row that began in an
// earlier chunk writes that row: its pieces [s, e) in chunk order, the
// first chunk's last run (slot 2c + 1) where the row starts inside that
// chunk, every later chunk's first run (slot 2c), and in place of the
// kGroup pieces of a group the row fills, their level-2 sum.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    finish_kernel(const int* __restrict__ keys, const int* __restrict__ row_start,
                  const float* __restrict__ pieces, const float* __restrict__ level2, int d,
                  int L, int nchunks, T* __restrict__ d_table) {
  constexpr int U = kInFlight<V>;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c == 0 || c >= nchunks) return;  // warp-uniform
  const int a = c * kChunk, b = min(L, a + kChunk);
  const int row = keys[a];
  if (keys[a - 1] != row) return;       // the row starts in this chunk
  const int e = run_end(keys, row, a, b);
  if (e == b && b < L && keys[b] == row) return;  // the row goes on past this chunk
  const int s = row_start[row];
  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    const int col = c0 + lane * V;
    const bool act = col < d;
    float acc[V] = {};
    int k = s / kChunk;
    const int k_end = (e - 1) / kChunk;
    bool tail = s != k * kChunk;
    while (k <= k_end) {  // warp-uniform
      Pack<float, V> rows[U];
      int n = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k > k_end) break;
        const float* src;
        if (tail) {
          src = pieces + (2LL * k + 1) * d;
          tail = false;
          ++k;
        } else if (k % kGroup == 0 && (long long)(k + kGroup) * kChunk <= e) {
          src = level2 + (long long)(k / kGroup) * d;
          k += kGroup;
        } else {
          src = pieces + 2LL * k * d;
          ++k;
        }
        if (act) rows[u] = *(const Pack<float, V>*)(src + col);
        ++n;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < n && act) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], rows[u].v[v]);
        }
      }
    }
    if (act) store_row<T, V>(d_table + (long long)row * d + col, acc);
  }
}

// Step 5: the dense pass. Warps step through the rows 32 at a time and
// write every row no entry touched as zeros, in row order.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    dense_kernel(const unsigned char* __restrict__ touched, int d, int nrows,
                 T* __restrict__ d_table) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps * 32;
  long long r0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  bool mark = r0 + lane < nrows ? touched[r0 + lane] : true;
  Pack<T, V> zero;
#pragma unroll
  for (int v = 0; v < V; ++v) narrow(0.f, zero.v[v]);
  for (; r0 < nrows; r0 += step) {
    unsigned untouched = __ballot_sync(REPRO_FULL_MASK, !mark);
    const long long r1 = r0 + step;  // the next step's marks, loaded ahead
    mark = r1 + lane < nrows ? touched[r1 + lane] : true;
    while (untouched) {  // warp-uniform
      const int k = __ffs(untouched) - 1;
      untouched &= untouched - 1;
      for (int col = lane * V; col < d; col += 32 * V)
        *(Pack<T, V>*)(d_table + (r0 + k) * d + col) = zero;
    }
  }
}

// gs[b] = g[b] / the bag's entry count, as the reference divides: its
// count is an f32 sum of ones (exact up to 2^24, where it stops growing),
// at least 1. One warp a bag at a time.
__global__ void __launch_bounds__(kThreads)
    scale_kernel(const float* __restrict__ g, const int* __restrict__ cnt, int nbags, int d,
                 float* __restrict__ gs) {
  const int lane = threadIdx.x & 31;
  for (long long bg = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); bg < nbags;
       bg += (long long)gridDim.x * kWarps) {
    const float c = (float)max(1, min(cnt[bg], 1 << 24));
    for (int col = lane; col < d; col += 32) gs[bg * d + col] = __fdiv_rn(g[bg * d + col], c);
  }
}

// d_w[i] = <table[idx[i]], gs[seg[i]]>: one warp an entry, each lane's
// columns lane, lane + 32, ... in order, then a butterfly.
template <typename T, typename IT, typename ST>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const T* __restrict__ table, const IT* __restrict__ idx, const ST* __restrict__ seg,
              const float* __restrict__ gs, int d, int L, float* __restrict__ d_w) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= L) return;
  const long long r = (long long)idx[i];
  const long long bg = seg ? (long long)seg[i] : i;
  float s = 0.f;
  for (int col = lane; col < d; col += 32)
    s = __fadd_rn(s, __fmul_rn(widen(table[r * d + col]), gs[bg * d + col]));
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(REPRO_FULL_MASK, s, o));
  if (lane == 0) d_w[i] = s;
}

struct Scratch {
  int *keys_a, *keys_b, *bags_a, *bags_b;  // the passes' outputs, in turn
  float *w_a, *w_b;                        // null without weights
  int *counts_a, *counts_b;                // [tiles][radix] tile counts, pass 1, 3 and pass 2
  int* totals;                             // [radix] digit totals
  unsigned char* touched;                  // [nrows]: cleared, then marked by the last pass
  int* row_start;                          // [nrows]: a touched row's first sorted position
  float *pieces, *level2;                  // [2 chunks][d], [groups][d]
  int* cnt;                                // [nbags] entry counts (mean mode)
  float* gs;                               // [nbags][d] g / count (mean mode)
};

// Step 1: the stable sort; keys, bags and ws get the last pass's arrays.
template <typename IT, typename ST>
cudaError_t sort_entries(const IT* idx, const ST* seg, const float* w, int L, int npasses,
                         const int* widths, bool mean, const Scratch& sc, cudaStream_t st,
                         const int** keys, const int** bags, const float** ws) {
  const int ntiles = (L + kTile - 1) / kTile;
  int* keys_out[2] = {sc.keys_a, sc.keys_b};
  int* bags_out[2] = {sc.bags_a, sc.bags_b};
  float* w_out[2] = {w ? sc.w_a : nullptr, w ? sc.w_b : nullptr};
  int* counts[2] = {sc.counts_a, sc.counts_b};
  const int next0 = npasses > 1 ? widths[1] : 0;
  cudaError_t err = sort_pass(CallerEntries<IT, ST>{idx, seg, w}, L, 0, widths[0], next0, ntiles,
                              counts[0], npasses > 1 ? counts[1] : nullptr, sc.totals,
                              mean ? sc.cnt : nullptr, true, keys_out[0], bags_out[0], w_out[0],
                              sc.touched, st);
  int shift = widths[0];
  for (int p = 1; p < npasses && err == cudaSuccess; ++p) {
    const int q = (p - 1) & 1;
    const bool more = p + 1 < npasses;
    err = sort_pass(SortedEntries{keys_out[q], bags_out[q], w_out[q]}, L, shift, widths[p],
                    more ? widths[p + 1] : 0, ntiles, counts[p & 1],
                    more ? counts[(p + 1) & 1] : nullptr, sc.totals, nullptr, false,
                    keys_out[q ^ 1], bags_out[q ^ 1], w_out[q ^ 1], sc.touched, st);
    shift += widths[p];
  }
  const int f = (npasses - 1) & 1;
  *keys = keys_out[f];
  *bags = bags_out[f];
  *ws = w_out[f];
  return err;
}

// Steps 2 to 5 with V columns a lane.
template <typename T, int V>
cudaError_t sum_and_write(const int* keys, const int* bags, const float* w, const float* gs,
                          int d, int L, int nrows, void* out, int sms, const Scratch& sc,
                          cudaStream_t st) {
  T* d_table = (T*)out;
  cudaError_t err = cudaSuccess;
  const int nchunks = (L + kChunk - 1) / kChunk;
  const int blocks = (nchunks + kWarps - 1) / kWarps;
  if (nchunks > 0) {
    if (w)
      chunk_kernel<T, V, true><<<blocks, kThreads, 0, st>>>(keys, bags, w, gs, d, L, nchunks,
                                                            sc.row_start, sc.pieces, d_table);
    else
      chunk_kernel<T, V, false><<<blocks, kThreads, 0, st>>>(keys, bags, w, gs, d, L, nchunks,
                                                             sc.row_start, sc.pieces, d_table);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (nchunks > 1) {
    const int ngroups = L / (kGroup * kChunk);
    if (ngroups > 0) {
      group_kernel<V><<<(ngroups + kWarps - 1) / kWarps, kThreads, 0, st>>>(
          keys, sc.pieces, d, ngroups, sc.level2);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    finish_kernel<T, V><<<blocks, kThreads, 0, st>>>(keys, sc.row_start, sc.pieces, sc.level2,
                                                     d, L, nchunks, d_table);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long want = ((long long)nrows + kWarps * 32 - 1) / (kWarps * 32);
  dense_kernel<T, V><<<(int)(want < 8LL * sms ? want : 8LL * sms), kThreads, 0, st>>>(
      sc.touched, d, nrows, d_table);
  return cudaGetLastError();
}

template <int V>
cudaError_t sum_and_write_as(int bf16, const int* keys, const int* bags, const float* w,
                             const float* gs, int d, int L, int nrows, void* d_table, int sms,
                             const Scratch& sc, cudaStream_t st) {
  if (bf16)
    return sum_and_write<__nv_bfloat16, V>(keys, bags, w, gs, d, L, nrows, d_table, sms, sc, st);
  return sum_and_write<float, V>(keys, bags, w, gs, d, L, nrows, d_table, sms, sc, st);
}

template <typename IT, typename ST>
cudaError_t launch(const void* table, int bf16, int nrows, int d, const IT* idx, const ST* seg,
                   const float* w, const float* g, bool mean, int nbags, int L, void* d_table,
                   float* d_w, int npasses, const int* widths, int sms, const Scratch& sc,
                   cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(sc.touched, 0, (size_t)nrows, st);
  if (err == cudaSuccess && mean) err = cudaMemsetAsync(sc.cnt, 0, sizeof(int) * (size_t)nbags, st);
  if (err != cudaSuccess) return err;
  const int* keys = nullptr;
  const int* bags = nullptr;
  const float* ws = nullptr;
  if (L > 0 && (err = sort_entries<IT, ST>(idx, seg, w, L, npasses, widths, mean, sc, st, &keys,
                                           &bags, &ws)) != cudaSuccess)
    return err;
  const float* gs = g;
  if (mean && L > 0) {
    scale_kernel<<<8 * sms, kThreads, 0, st>>>(g, sc.cnt, nbags, d, sc.gs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    gs = sc.gs;
  }
  // the fewest columns a lane that covers d in one pass (at most 4), as
  // the width and the rows' alignment allow
  int v = d <= 32 ? 1 : d <= 64 ? 2 : 4;
  while (v > 1 && (d % v || (uintptr_t)gs % (v * sizeof(float)))) v >>= 1;
  switch (v) {
    case 4: err = sum_and_write_as<4>(bf16, keys, bags, ws, gs, d, L, nrows, d_table, sms, sc, st); break;
    case 2: err = sum_and_write_as<2>(bf16, keys, bags, ws, gs, d, L, nrows, d_table, sms, sc, st); break;
    default: err = sum_and_write_as<1>(bf16, keys, bags, ws, gs, d, L, nrows, d_table, sms, sc, st);
  }
  if (err != cudaSuccess || !d_w || L == 0) return err;
  const int blocks = (L + kWarps - 1) / kWarps;
  if (bf16)
    dw_kernel<__nv_bfloat16, IT, ST><<<blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)table, idx, seg, gs, d, L, d_w);
  else
    dw_kernel<float, IT, ST><<<blocks, kThreads, 0, st>>>((const float*)table, idx, seg, gs, d,
                                                          L, d_w);
  return cudaGetLastError();
}

template <typename IT>
cudaError_t launch_seg(const void* seg, int seg64, const IT* idx, const void* table, int bf16,
                       int nrows, int d, const float* w, const float* g, bool mean, int nbags,
                       int L, void* d_table, float* d_w, int npasses, const int* widths, int sms,
                       const Scratch& sc, cudaStream_t st) {
  if (seg64)
    return launch<IT, long long>(table, bf16, nrows, d, idx, (const long long*)seg, w, g, mean,
                                 nbags, L, d_table, d_w, npasses, widths, sms, sc, st);
  return launch<IT, int>(table, bf16, nrows, d, idx, (const int*)seg, w, g, mean, nbags, L,
                         d_table, d_w, npasses, widths, sms, sc, st);
}

}  // namespace

// table [nrows, d] (float32, or bfloat16 when bf16 != 0), contiguous; idx
// [L] int32 (int64 where idx64) rows in [0, nrows), in the caller's order;
// seg [L] int32 (int64 where seg64) bags in [0, nbags), in any order, or
// null for a gather's transpose (entry i is bag i, nbags = L); w [L]
// float32 or null (every weight 1); g [nbags, d] float32 grad_out; mean:
// divide g by each bag's entry count (at least 1); d_table [nrows, d] of
// the table's type, every row written here; d_w [L] float32 or null (not
// wanted; needs seg). The sort's digit passes, lowest digit first:
// npasses (1 to 3) widths of width0, width1, width2 bits, together at
// least ceil(log2 nrows). Scratch, from the wrapper's plan
// (kernels/bag/bag.py::backward_plan): keys_a, keys_b, bags_a, bags_b [L]
// int32; w_a, w_b [L] float32 (null without w); counts_a, counts_b
// [tiles * radix] int32 (radix: 2^ the widest pass, tiles ceil(L / 4096);
// counts_b null for one pass) and totals [radix]; touched [nrows] bytes;
// row_start [nrows] int32; pieces [2 ceil(L / 256), d] and level2
// [floor(L / 16384), d] float32; cnt [nbags] int32 and gs [nbags, d]
// float32 (mean mode, else null). sms: the card's multiprocessors.
extern "C" int bag_backward_launch(const void* table, int bf16, int nrows, int d,
                                   const void* idx, int idx64, const void* seg, int seg64,
                                   const float* w, const float* g, int mean, int nbags, int L,
                                   void* d_table, float* d_w, int npasses, int width0,
                                   int width1, int width2, int sms, int* keys_a, int* keys_b,
                                   int* bags_a, int* bags_b, float* w_a, float* w_b,
                                   int* counts_a, int* counts_b, int* totals,
                                   unsigned char* touched, int* row_start, float* pieces,
                                   float* level2, int* cnt, float* gs, void* stream) {
  const int widths[kMaxPasses] = {width0, width1, width2};
  if (npasses < 1 || npasses > kMaxPasses) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < npasses; ++p)
    if (widths[p] < 1 || (1 << widths[p]) > kMaxRadix) return (int)cudaErrorInvalidValue;
  const Scratch sc{keys_a, keys_b, bags_a, bags_b, w_a, w_b, counts_a, counts_b, totals,
                   touched, row_start, pieces, level2, cnt, gs};
  cudaStream_t st = (cudaStream_t)stream;
  if (idx64)
    return (int)launch_seg<long long>(seg, seg64, (const long long*)idx, table, bf16, nrows, d, w,
                                      g, mean != 0, nbags, L, d_table, d_w, npasses, widths, sms,
                                      sc, st);
  return (int)launch_seg<int>(seg, seg64, (const int*)idx, table, bf16, nrows, d, w, g,
                              mean != 0, nbags, L, d_table, d_w, npasses, widths, sms, sc, st);
}
