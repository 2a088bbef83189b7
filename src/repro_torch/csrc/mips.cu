// Top-k maximum inner product search over the valid rows of an index.
//
// Replaces: src/repro/kernels/mips/mips.py::mips_topk_pallas (_mips_kernel).
//
// Two paths, chosen from the shape by the wrapper (kernels/mips/mips.py,
// mips_plan), each two launches: select per block of index rows, then
// merge per query. Both paths merge with mips_threshold_merge_kernel.
//
// Blocked path — small index, small k (the streaming-RAG flush: Q = 64
// queries against 4218 x 384 prototypes, k = 10, and the staged route at
// k = nprobe = 8). Bound there: operations, about 0.2 GFLOP of fp32 (3.1 us
// at 67 TFLOP/s) against 6.5 MB read (2 us). (1) mips_tile_kernel: a block
// of 256 threads scores a tile of 16 * TQ queries x 32 index rows (TQ = 4,
// 2 or 1, the least that holds Q: 64 queries, so 132 tiles at N = 4218
// fill the 132 SMs), each index row read from device memory once for the
// tile's queries. The tile's queries and rows are staged in slabs of 64
// components by cp.async (16 bytes, zero-filled past Q, N and d), four
// slabs deep. A thread holds a register block of TQ queries x 2 rows; the
// 8 warps split the tile 4 x 2, so a warp's 32 lanes read 4 distinct
// query rows and 8 distinct index rows a step (broadcasts in shared
// memory, no bank conflict), TQ + 2 16-byte loads feeding 8 TQ FMAs.
// Every dot is one fp32 sum over d in order (no split over d, no tensor
// cores), so a query's scores do not depend on the other queries in the
// call. The epilogue writes the tile's keys (keys.cuh's composite keys:
// ordered score bits, then the lowest row; invalid rows NEG_INF, rows past
// N key 0) to shared memory, and a warp a query sorts the query's 32 keys
// by a bitonic network across its lanes (15 steps of a shuffle), keeping
// the k largest and the k-th, the tile's bound. (2) The merge of the
// threshold path (below), one block a query over the ceil(N / 32) * k
// keys, pruned at the largest tile's k-th key: no k serial passes. It is a
// programmatic dependent launch: its blocks start at the tiles' epilogue
// and wait for their keys. The tile's shape was chosen on the card among
// 2 or 4 rows a thread, 32- or 64-component slabs and 3 to 12 stages
// (deeper staging did not help: the tile is bound by shared-memory loads
// and its fixed costs, not by load latency). On an H100 80GB HBM3 at
// 700 W: 0.023 ms against the first design's 0.042 (tools/kernel_ab.py
// mips10; PERF.md).
//
// Threshold path — everything else, above all recsys retrieval: Q = 1 or
// 4 queries against 1,000,000 item rows, k = 100. Bound: bytes (the 256
// MB table at d = 64 read once, 77 us at 3.35 TB/s); the 0.5 GFLOP of
// fp32 takes 8 us. (1) mips_select_kernel: one block of 1024 threads per
// bn <= 8192 rows and group of QB <= 8 queries (QB is a template
// parameter, so Q = 1 pays for one query). A group of 8 lanes scores a
// row, each lane loading an eighth of it 16 bytes at a time where d % 4 ==
// 0 (a pair of lanes with 4-byte loads otherwise: rows of d = 18 or 11 are
// not 16-byte aligned), so each load instruction reads whole sectors and
// nothing waits on L1 to keep a sector for a later load; two rows per
// group are in flight at once; 3 shuffles per row and query (1 for the
// pair) add the lanes' parts. (Lanes per row were chosen on the card:
// 8 and 2 scored fastest of 1, 2, 4, 8 and 16.) The queries sit in shared
// memory. Each row's ordered score bits go to shared memory. Then, per
// query, each thread holds 8 composite keys (keys.cuh: score desc, then
// lowest row, unique) in registers; every warp finds its 4 largest keys
// (k = 100 over 32 warps) by warp max rounds with no barrier, and the
// 100th largest of those 128 bounds the block's 100th key from below
// (block_topk_bound). The ~110 keys at or above it are gathered and each
// ranked against the others, so the block writes its k keys in order and
// its k-th key. (2) mips_threshold_merge_kernel: one block of 1024 threads
// per query. T = the largest of the blocks' k-th keys is a lower bound on
// the global k-th key, so only keys >= T can be in the answer (about 9,000
// of the 12,300 at MIND's shape); the keys are read 16 to a thread into
// registers, those under T zeroed, and the rest cut by the same warp bound
// and ranked straight into the output. Where a bound fails (short or mostly invalid blocks, k above
// 256, more candidates than kRankCap), an exact block-wide search
// (block_topk_threshold: 8-way splits of the key range, one barrier per
// step) finds the k-th key instead, and a bitonic sort orders the merge's
// k; where a query has more than kMergeCap keys (over 163 blocks at k =
// 100), the survivors go to device memory and the search counts them
// there. All of it is exact, ties included, because keys are unique.
// Invalid rows score NEG_INF and follow every valid row, lowest row first;
// rows past N are never keys. Tensor cores are not used:
// the contract is full-fp32 sums.
#include "keys.cuh"

namespace {

constexpr int kSelectThreads = 1024;
constexpr int kSelectSlots = 8;    // keys a thread holds: bn <= 8192
constexpr int kMergeSlots = 16;
constexpr int kMergeCap = kSelectThreads * kMergeSlots;  // keys a merge holds in registers
constexpr int kMaxThresholdK = 8192;  // largest k of the threshold path (sort buffer)

template <int SLOTS>
__device__ __forceinline__ key64 local_max_of(const key64 (&keys)[SLOTS]) {
  key64 m = 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) m = max(m, keys[s]);
  return m;
}

// grid (nblk, ceil(Q / QB)). part_keys [Q, nblk, k], part_t [Q, nblk].
template <int QB, bool VEC>
__global__ void __launch_bounds__(kSelectThreads)
    mips_select_kernel(const float* __restrict__ q, int Q, int d,
                       const float* __restrict__ index, int N,
                       const unsigned char* __restrict__ valid, int k, int bn,
                       key64* __restrict__ part_keys, key64* __restrict__ part_t) {
  constexpr int G = VEC ? 8 : 2;           // lanes per row
  constexpr int NG = kSelectThreads / G;   // row groups
  extern __shared__ __align__(16) key64 rbuf[];  // [kRankCap] candidates to rank
  float* sq = (float*)(rbuf + kRankCap);          // [QB, d]
  unsigned* sv = (unsigned*)(sq + QB * d);        // [QB, bn] ordered score bits
  __shared__ unsigned wcnt[2 * kSplit * 32];
  __shared__ key64 smax;
  __shared__ int count;

  const int q0 = blockIdx.y * QB, nq = min(QB, Q - q0);
  const int blk = blockIdx.x, nblk = gridDim.x;
  const long long base = (long long)blk * bn;
  const int nrows = (int)min((long long)bn, (long long)N - base);
  for (int e = threadIdx.x; e < QB * d; e += blockDim.x) {
    const int qq = e / d;
    sq[e] = qq < nq ? q[(size_t)(q0 + qq) * d + (e - qq * d)] : 0.f;
  }
  __syncthreads();

  const int sub = threadIdx.x & (G - 1), grp = threadIdx.x / G;
  const int iters = (nrows + 2 * NG - 1) / (2 * NG);  // uniform: shuffles below
  for (int it = 0; it < iters; ++it) {
    const int j0 = grp + it * 2 * NG, j1 = j0 + NG;
    // rows past the block read row 0 of it and are not written
    const float* r0 = index + (base + (j0 < nrows ? j0 : 0)) * d;
    const float* r1 = index + (base + (j1 < nrows ? j1 : 0)) * d;
    float a0[QB], a1[QB];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) a0[qq] = a1[qq] = 0.f;
    if (VEC) {
      const int d4 = d >> 2;
      const float4* sq4 = (const float4*)sq;
#pragma unroll 4
      for (int c = sub; c < d4; c += G) {
        const float4 x0 = __ldg((const float4*)r0 + c);
        const float4 x1 = __ldg((const float4*)r1 + c);
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) {
          const float4 w = sq4[qq * d4 + c];
          a0[qq] = fmaf(x0.w, w.w, fmaf(x0.z, w.z, fmaf(x0.y, w.y, fmaf(x0.x, w.x, a0[qq]))));
          a1[qq] = fmaf(x1.w, w.w, fmaf(x1.z, w.z, fmaf(x1.y, w.y, fmaf(x1.x, w.x, a1[qq]))));
        }
      }
    } else {
#pragma unroll 4
      for (int t = sub; t < d; t += G) {
        const float x0 = __ldg(r0 + t), x1 = __ldg(r1 + t);
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) {
          const float w = sq[qq * d + t];
          a0[qq] = fmaf(x0, w, a0[qq]);
          a1[qq] = fmaf(x1, w, a1[qq]);
        }
      }
    }
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) {
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        a0[qq] += __shfl_xor_sync(REPRO_FULL_MASK, a0[qq], o);
        a1[qq] += __shfl_xor_sync(REPRO_FULL_MASK, a1[qq], o);
      }
    }
    if (sub == 0) {
      if (j0 < nrows) {
        const bool ok = valid[base + j0] != 0;
#pragma unroll
        for (int qq = 0; qq < QB; ++qq)
          sv[qq * bn + j0] = ordered_bits(ok ? a0[qq] : REPRO_NEG_INF);
      }
      if (j1 < nrows) {
        const bool ok = valid[base + j1] != 0;
#pragma unroll
        for (int qq = 0; qq < QB; ++qq)
          sv[qq * bn + j1] = ordered_bits(ok ? a1[qq] : REPRO_NEG_INF);
      }
    }
  }
  __syncthreads();

  const unsigned row0 = (unsigned)base;
  for (int qq = 0; qq < nq; ++qq) {  // block-uniform
    key64 keys[kSelectSlots];
#pragma unroll
    for (int s = 0; s < kSelectSlots; ++s) {
      const int j = threadIdx.x + s * kSelectThreads;
      keys[s] = j < nrows ? make_key(sv[qq * bn + j], row0 + (unsigned)j) : 0;
    }
    key64* out = part_keys + ((size_t)(q0 + qq) * nblk + blk) * k;
    key64* pt = part_t + (size_t)(q0 + qq) * nblk + blk;
    if (threadIdx.x == 0) count = 0;
    if (nrows <= k) {  // a short block keeps every row, then key 0
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSelectSlots; ++s) warp_append(keys[s] != 0, keys[s], out, k, &count);
      for (int i = nrows + threadIdx.x; i < k; i += blockDim.x) out[i] = 0;
      if (threadIdx.x == 0) *pt = nrows < k ? 0 : 1;
    } else {
      // candidates at or above a cheap bound, ranked: out in order, the
      // k-th key to part_t; an exact search where the bound fails
      const key64 t1 = block_topk_bound(keys, k, &smax);
      if (t1 != 0) {
#pragma unroll
        for (int s = 0; s < kSelectSlots; ++s)
          warp_append(keys[s] >= t1, keys[s], rbuf, kRankCap, &count);
        __syncthreads();
      }
      const int n = count;
      if (t1 != 0 && n <= kRankCap) {
        block_rank_emit(rbuf, n, k, [&](int r, key64 key) {
          out[r] = key;
          if (r == k - 1) *pt = key;
        });
      } else {
        const key64 t = block_topk_threshold(local_max_of(keys), k,
                                             [&](const key64* sp, unsigned* c) {
#pragma unroll
          for (int s = 0; s < kSelectSlots; ++s)
#pragma unroll
            for (int j = 0; j < kSplit; ++j) c[j] += keys[s] >= sp[j];
        }, wcnt, &smax);
        if (threadIdx.x == 0) count = 0;
        __syncthreads();
#pragma unroll
        for (int s = 0; s < kSelectSlots; ++s) warp_append(keys[s] >= t, keys[s], out, k, &count);
        if (threadIdx.x == 0) *pt = t;
      }
    }
    __syncthreads();  // count and rbuf are reused by the next query
  }
}

// grid (Q), kSelectThreads threads. m = nblk * k keys per query; spill
// [Q, m] is scratch for m > kMergeCap.
__global__ void __launch_bounds__(kSelectThreads)
    mips_threshold_merge_kernel(const key64* __restrict__ part_keys,
                                const key64* __restrict__ part_t, int nblk, int k, int P,
                                key64* __restrict__ spill, float* __restrict__ out_scores,
                                int* __restrict__ out_ids) {
  extern __shared__ __align__(16) key64 sorted[];  // [max(P, kRankCap)]
  __shared__ unsigned wcnt[2 * kSplit * 32];
  __shared__ key64 smax, T;
  __shared__ int picked;

  const int qi = blockIdx.x, m = nblk * k;
  const key64* keys = part_keys + (size_t)qi * m;
  // a programmatic dependent launch starts before the kernel that wrote
  // part_keys ends: wait for it (a no-op in an ordinary launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float* os = out_scores + (size_t)qi * k;
  int* oi = out_ids + (size_t)qi * k;
  auto write = [&](int r, key64 key) {
    os[r] = key_score(key);
    oi[r] = key_row(key);
  };
  if (threadIdx.x == 0) {
    T = 0;
    picked = 0;
  }
  __syncthreads();
  key64 tb = 0;
  for (int b = threadIdx.x; b < nblk; b += blockDim.x)
    tb = max(tb, part_t[(size_t)qi * nblk + b]);
  atomicMax(&T, tb);
  for (int i = k + threadIdx.x; i < P; i += blockDim.x) sorted[i] = 0;
  __syncthreads();
  const key64 thr = T;  // non-zero keys >= T: at least k of them

  if (m <= kMergeCap) {
    // the survivors stay in registers, 16 to a thread (0 where pruned)
    key64 reg[kMergeSlots];
#pragma unroll
    for (int s = 0; s < kMergeSlots; ++s) {
      const int i = threadIdx.x + s * kSelectThreads;
      const key64 key = i < m ? keys[i] : 0;
      reg[s] = key >= thr ? key : 0;
    }
    // candidates at or above a cheap bound, ranked straight into the
    // output; an exact search where the bound fails
    const key64 t1 = block_topk_bound(reg, k, &smax);
    if (t1 != 0) {
#pragma unroll
      for (int s = 0; s < kMergeSlots; ++s)
        warp_append(reg[s] >= t1, reg[s], sorted, kRankCap, &picked);
      __syncthreads();
      const int np = picked;
      if (np <= kRankCap) {
        block_rank_emit(sorted, np, k, write);
        return;  // block-uniform
      }
      __syncthreads();
      if (threadIdx.x == 0) picked = 0;
      for (int i = k + threadIdx.x; i < P; i += blockDim.x) sorted[i] = 0;
      __syncthreads();
    }
    const key64 t = block_topk_threshold(local_max_of(reg), k,
                                         [&](const key64* sp, unsigned* c) {
#pragma unroll
      for (int s = 0; s < kMergeSlots; ++s)
#pragma unroll
        for (int j = 0; j < kSplit; ++j) c[j] += reg[s] >= sp[j];
    }, wcnt, &smax);
#pragma unroll
    for (int s = 0; s < kMergeSlots; ++s) warp_append(reg[s] >= t, reg[s], sorted, k, &picked);
  } else {
    // the survivors to the spill list in device memory, counted there
    key64* sp = spill + (size_t)qi * m;
    __shared__ int n;
    if (threadIdx.x == 0) n = 0;
    __syncthreads();
    key64 local_max = 0;
    for (int b0 = 0; b0 < m; b0 += blockDim.x) {
      const int i = b0 + threadIdx.x;
      const key64 key = i < m ? keys[i] : 0;
      const bool take = key >= thr && key;
      if (take) local_max = max(local_max, key);
      warp_append(take, key, sp, m, &n);
    }
    __syncthreads();
    const int ns = n;
    const key64 t = block_topk_threshold(local_max, k, [&](const key64* s, unsigned* c) {
      for (int i = threadIdx.x; i < ns; i += blockDim.x) {
        const key64 key = sp[i];
#pragma unroll
        for (int j = 0; j < kSplit; ++j) c[j] += key >= s[j];
      }
    }, wcnt, &smax);
    for (int b0 = 0; b0 < ns; b0 += blockDim.x) {
      const int i = b0 + threadIdx.x;
      const key64 key = i < ns ? sp[i] : 0;
      warp_append(key >= t, key, sorted, k, &picked);
    }
  }
  __syncthreads();
  block_bitonic_desc(sorted, P);
  for (int i = threadIdx.x; i < k; i += blockDim.x) write(i, sorted[i]);
}

template <int QB>
cudaError_t launch_select(const float* q, int Q, int d, const float* index, int N,
                          const unsigned char* valid, int k, int bn, key64* part_keys,
                          key64* part_t, cudaStream_t st) {
  const size_t smem = kRankCap * sizeof(key64) + (size_t)QB * (d + bn) * sizeof(float);
  const dim3 grid((unsigned)((N + (long long)bn - 1) / bn), (Q + QB - 1) / QB);
  cudaError_t err;
  if (d % 4 == 0 && (uintptr_t)index % 16 == 0) {
    if ((err = allow_smem(mips_select_kernel<QB, true>, smem)) != cudaSuccess) return err;
    mips_select_kernel<QB, true><<<grid, kSelectThreads, smem, st>>>(
        q, Q, d, index, N, valid, k, bn, part_keys, part_t);
  } else {
    if ((err = allow_smem(mips_select_kernel<QB, false>, smem)) != cudaSuccess) return err;
    mips_select_kernel<QB, false><<<grid, kSelectThreads, smem, st>>>(
        q, Q, d, index, N, valid, k, bn, part_keys, part_t);
  }
  return cudaGetLastError();
}

// ---- blocked path: the tiles
constexpr int kTileRows = 32;      // index rows a tile scores
constexpr int kTileStages = 4;     // slabs in shared memory at once
constexpr int kTR = 2;             // rows a thread holds
constexpr int kSlab = 64;          // components staged a step
constexpr int kLd = kSlab + 4;     // a staged row's stride in floats (16-byte aligned)
constexpr int kRowLanes = 16 / kTR;          // lanes of a warp on distinct rows: 8
constexpr int kQueryLanes = 32 / kRowLanes;  // lanes of a warp on distinct queries: 4
constexpr int kTileThreads = 2 * 32 * (16 / kQueryLanes);   // 2 row halves x 4 query warps

// Dynamic shared memory of a tile of 16 * tq queries: the staged slabs,
// reused for the tile's keys once the dots are done.
constexpr size_t tile_smem_bytes(int tq) {
  const size_t slabs = (size_t)kTileStages * (16 * tq + kTileRows) * kLd * sizeof(float);
  const size_t keys = (size_t)16 * tq * (kTileRows + 1) * sizeof(key64);
  return slabs > keys ? slabs : keys;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 16 : 0));
}

// grid (ceil(N / 32), ceil(Q / (16 * TQ))). part_keys [Q, k, nblk]: each
// (query, tile)'s k largest keys (0 past the tile's rows), rank-major, so
// that a tile's keys spread over the merge's warps and its warp bound
// (block_topk_bound) holds; part_t [Q, nblk]: the k-th of them, a lower
// bound of the query's k-th key (0 where the tile has fewer than k rows).
// k <= 32.
template <int TQ, bool VEC>
__global__ void __launch_bounds__(kTileThreads)
    mips_tile_kernel(const float* __restrict__ q, int Q, int d,
                     const float* __restrict__ index, int N,
                     const unsigned char* __restrict__ valid, int k,
                     key64* __restrict__ part_keys, key64* __restrict__ part_t) {
  constexpr int BQ = 16 * TQ;   // queries of the tile
  extern __shared__ __align__(16) float tile_smem[];
  float* qs = tile_smem;                             // [kTileStages][BQ][kLd]
  float* rs = tile_smem + kTileStages * BQ * kLd;    // [kTileStages][kTileRows][kLd]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the thread's queries qw + kQueryLanes i (i < TQ) and rows rw +
  // kRowLanes j (j < kTR): a warp's lanes read neighbouring query rows and
  // neighbouring index rows, so each 16-byte load falls on distinct banks
  const int qw = (warp >> 1) * kQueryLanes * TQ + lane / kRowLanes;
  const int rw = (warp & 1) * 16 + lane % kRowLanes;
  const int row0 = blockIdx.y * BQ, col0 = blockIdx.x * kTileRows;
  const int steps = (d + kSlab - 1) / kSlab;

  // slab s (components [s * kSlab, +kSlab)) of the tile's queries and rows
  // into stage buffer b
  auto issue = [&](int s, int b) {
    if (s >= steps) return;
    const int k0 = s * kSlab;
    float* qb = qs + b * BQ * kLd;
    float* rb = rs + b * kTileRows * kLd;
    if (VEC) {
      constexpr int kChunks = kSlab / 4;   // 16-byte chunks to a slab row
      for (int e = tid; e < BQ * kChunks; e += kTileThreads) {
        const int r = e / kChunks, c = 4 * (e % kChunks);
        const bool ok = row0 + r < Q && k0 + c < d;
        cp_async16(qb + r * kLd + c, ok ? q + (size_t)(row0 + r) * d + k0 + c : q, ok);
      }
      for (int e = tid; e < kTileRows * kChunks; e += kTileThreads) {
        const int r = e / kChunks, c = 4 * (e % kChunks);
        const bool ok = col0 + r < N && k0 + c < d;
        cp_async16(rb + r * kLd + c, ok ? index + (size_t)(col0 + r) * d + k0 + c : index, ok);
      }
    } else {
      for (int e = tid; e < BQ * kSlab; e += kTileThreads) {
        const int r = e / kSlab, c = e % kSlab;
        qb[r * kLd + c] = (row0 + r < Q && k0 + c < d) ? q[(size_t)(row0 + r) * d + k0 + c] : 0.f;
      }
      for (int e = tid; e < kTileRows * kSlab; e += kTileThreads) {
        const int r = e / kSlab, c = e % kSlab;
        rb[r * kLd + c] =
            (col0 + r < N && k0 + c < d) ? index[(size_t)(col0 + r) * d + k0 + c] : 0.f;
      }
    }
  };

  float acc[TQ][kTR];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < kTR; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kTileStages - 1; ++s) {
    issue(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int s = 0; s < steps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kTileStages - 2));  // slab s landed
    __syncthreads();  // ... for every thread, and no one still reads slab s - 1
    issue(s + kTileStages - 1, (s + kTileStages - 1) % kTileStages);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* qb = qs + (s % kTileStages) * BQ * kLd + qw * kLd;
    const float* rb = rs + (s % kTileStages) * kTileRows * kLd + rw * kLd;
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 4) {
      float4 x[TQ], y[kTR];
#pragma unroll
      for (int i = 0; i < TQ; ++i) x[i] = *(const float4*)(qb + kQueryLanes * i * kLd + kk);
#pragma unroll
      for (int j = 0; j < kTR; ++j) y[j] = *(const float4*)(rb + kRowLanes * j * kLd + kk);
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < kTR; ++j) {  // components in order: one sum over d
          float t = fmaf(x[i].x, y[j].x, acc[i][j]);
          t = fmaf(x[i].y, y[j].y, t);
          t = fmaf(x[i].z, y[j].z, t);
          acc[i][j] = fmaf(x[i].w, y[j].w, t);
        }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  // the merge may start now: its blocks set up beside this epilogue
  asm volatile("griddepcontrol.launch_dependents;\n");
  __syncthreads();  // every slab read: the stage buffers hold the keys now

  key64* keys = (key64*)tile_smem;   // [BQ][kTileRows + 1]
#pragma unroll
  for (int j = 0; j < kTR; ++j) {
    const int c = col0 + rw + kRowLanes * j;
    const bool ok = c < N && valid[c];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
      keys[(qw + kQueryLanes * i) * (kTileRows + 1) + rw + kRowLanes * j] =
          c < N ? make_key(ordered_bits(ok ? acc[i][j] : REPRO_NEG_INF), (unsigned)c) : 0ull;
  }
  __syncthreads();
  const int nblk = gridDim.x;
  for (int qq = warp; qq < BQ && row0 + qq < Q; qq += kTileThreads / 32) {  // warp-uniform
    key64 v = keys[qq * (kTileRows + 1) + lane];
    // bitonic sort of the 32 keys across the lanes, descending
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const key64 o = __shfl_xor_sync(REPRO_FULL_MASK, v, stride);
        const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
        v = keep_max ? max(v, o) : min(v, o);
      }
    const size_t qi = (size_t)(row0 + qq);
    if (lane < k) part_keys[(qi * k + lane) * nblk + blockIdx.x] = v;
    if (lane == k - 1) part_t[qi * nblk + blockIdx.x] = v;
  }
}

template <int TQ>
cudaError_t launch_tiles(const float* q, int Q, int d, const float* index, int N,
                         const unsigned char* valid, int k, key64* part_keys, key64* part_t,
                         cudaStream_t st) {
  const dim3 grid((N + kTileRows - 1) / kTileRows, (Q + 16 * TQ - 1) / (16 * TQ));
  const size_t smem = tile_smem_bytes(TQ);
  cudaError_t err;
  if (d % 4 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)index % 16 == 0) {
    if ((err = allow_smem(mips_tile_kernel<TQ, true>, smem)) != cudaSuccess) return err;
    mips_tile_kernel<TQ, true><<<grid, kTileThreads, smem, st>>>(q, Q, d, index, N, valid, k,
                                                                 part_keys, part_t);
  } else {
    if ((err = allow_smem(mips_tile_kernel<TQ, false>, smem)) != cudaSuccess) return err;
    mips_tile_kernel<TQ, false><<<grid, kTileThreads, smem, st>>>(q, Q, d, index, N, valid, k,
                                                                  part_keys, part_t);
  }
  return cudaGetLastError();
}

// The merge of either path: Q blocks over the [Q, nblk * k] keys; as a
// programmatic dependent launch (it waits for the tiles' keys inside) where
// `dependent`.
cudaError_t launch_merge(const key64* pk, const key64* pt, int Q, int nblk, int k, int P,
                         key64* spill, float* out_scores, int* out_ids, cudaStream_t st,
                         bool dependent = false) {
  const size_t smem = (size_t)max(P, kRankCap) * sizeof(key64);
  cudaError_t err = allow_smem(mips_threshold_merge_kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q);
  cfg.blockDim = dim3(kSelectThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, mips_threshold_merge_kernel, pk, pt, nblk, k, P, spill,
                            out_scores, out_ids);
}

}  // namespace

// ---- blocked path
extern "C" int mips_tile_rows() { return kTileRows; }

// tq in {4, 2, 1} (the tile's queries / 16), k <= 32, P the power of two
// >= k; part_keys and spill [Q, k * nblk], part_t [Q, nblk] (nblk =
// ceil(N / 32)). phases: 1 = tiles, 2 = merge, 3 = both.
extern "C" int mips_launch(const float* q, int Q, int d, const float* index, int N,
                           const unsigned char* valid, int k, int tq, int P, void* part_keys,
                           void* part_t, void* spill, float* out_scores, int* out_ids,
                           int phases, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > kTileRows || P < k || (P & (P - 1))) return (int)cudaErrorInvalidValue;
  key64* pk = (key64*)part_keys;
  key64* pt = (key64*)part_t;
  cudaError_t err = cudaSuccess;
  if (phases & 1) {
    switch (tq) {
      case 4: err = launch_tiles<4>(q, Q, d, index, N, valid, k, pk, pt, st); break;
      case 2: err = launch_tiles<2>(q, Q, d, index, N, valid, k, pk, pt, st); break;
      case 1: err = launch_tiles<1>(q, Q, d, index, N, valid, k, pk, pt, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    err = launch_merge(pk, pt, Q, (N + kTileRows - 1) / kTileRows, k, P, (key64*)spill,
                       out_scores, out_ids, st, true);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// ---- threshold path
extern "C" int mips_select_threads() { return kSelectThreads; }
extern "C" int mips_select_slots() { return kSelectSlots; }
extern "C" int mips_merge_cap() { return kMergeCap; }
extern "C" int mips_threshold_max_k() { return kMaxThresholdK; }

// qb in {1, 2, 4, 8}; bn a multiple of kSelectThreads, at most
// kSelectThreads * kSelectSlots; P the power of two >= k; part_keys and
// spill [Q, nblk * k], part_t [Q, nblk] (nblk = ceil(N / bn)). phases as
// mips_launch.
extern "C" int mips_threshold_launch(const float* q, int Q, int d, const float* index,
                                     int N, const unsigned char* valid, int k, int qb,
                                     int bn, int P, void* part_keys, void* part_t,
                                     void* spill, float* out_scores, int* out_ids,
                                     int phases, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bn % kSelectThreads || bn > kSelectThreads * kSelectSlots || k > kMaxThresholdK ||
      P < k || (P & (P - 1)))
    return (int)cudaErrorInvalidValue;
  key64* pk = (key64*)part_keys;
  key64* pt = (key64*)part_t;
  cudaError_t err = cudaSuccess;
  if (phases & 1) {
    switch (qb) {
      case 1: err = launch_select<1>(q, Q, d, index, N, valid, k, bn, pk, pt, st); break;
      case 2: err = launch_select<2>(q, Q, d, index, N, valid, k, bn, pk, pt, st); break;
      case 4: err = launch_select<4>(q, Q, d, index, N, valid, k, bn, pk, pt, st); break;
      case 8: err = launch_select<8>(q, Q, d, index, N, valid, k, bn, pk, pt, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    err = launch_merge(pk, pt, Q, (int)((N + (long long)bn - 1) / bn), k, P, (key64*)spill,
                       out_scores, out_ids, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
