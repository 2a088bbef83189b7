// Top-k maximum inner product search over the valid rows of an index.
//
// Replaces: src/repro/kernels/mips/mips.py::mips_topk_pallas (_mips_kernel).
//
// Two paths, chosen from the shape by the wrapper (kernels/mips/mips.py,
// mips_plan), each two launches: select per block of index rows, then
// merge per query.
//
// Blocked path — small index, small k (the streaming-RAG flush: Q = 64
// queries against 4218 x 384 prototypes, k = 10). Bound there: about 0.2
// GFLOP of fp32 (3 us at 67 TFLOP/s) against 6.5 MB read (2 us).
// rows_topk_kernel (topk.cuh) scores blocks of 8
// queries against bn rows (warp per row, each row read once per 8
// queries) and keeps each query's top-k per block by k warp-wide passes;
// mips_merge_kernel (one warp per query) merges the survivors in k passes.
// Both costs grow with k and with the number of blocks, which is small
// here.
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
#include "topk.cuh"

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

__global__ void mips_merge_kernel(float* __restrict__ part_val,
                                  const int* __restrict__ part_idx, int Q, int m,
                                  int k, float* __restrict__ out_scores,
                                  int* __restrict__ out_ids) {
  const int qi = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (qi >= Q) return;  // warp-uniform
  float* os = out_scores + (size_t)qi * k;
  int* oi = out_ids + (size_t)qi * k;
  topk_merge_warp(part_val + (size_t)qi * m, part_idx + (size_t)qi * m, m, k,
                  [=](int t, float v, int i) {
                    os[t] = v;
                    oi[t] = i;
                  });
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

}  // namespace

// ---- blocked path
extern "C" int mips_rows_per_block(int N, int Q, int k) { return rows_per_block(N, Q, k); }

extern "C" long long mips_smem_bytes(int d, int N, int Q, int k) {
  return (long long)rows_topk_smem(d, rows_per_block(N, Q, k));
}

// phases: 1 = select, 2 = merge, 3 = both (the merge retires its picks in
// part_val, so a merge alone runs on what the last select left)
extern "C" int mips_launch(const float* q, int Q, int d, const float* index, int N,
                           const unsigned char* valid, int k, int bn, float* part_val,
                           int* part_idx, float* out_scores, int* out_ids, int phases,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (phases & 1) {
    cudaError_t err = launch_rows_topk(q, Q, d, index, N, valid, k, bn, part_val,
                                       part_idx, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    const int m = ((N + bn - 1) / bn) * k;
    mips_merge_kernel<<<(Q * 32 + 255) / 256, 256, 0, st>>>(part_val, part_idx, Q, m, k,
                                                             out_scores, out_ids);
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
    const int nblk = (int)((N + (long long)bn - 1) / bn);
    const size_t smem = (size_t)max(P, kRankCap) * sizeof(key64);
    if ((err = allow_smem(mips_threshold_merge_kernel, smem)) != cudaSuccess)
      return (int)err;
    mips_threshold_merge_kernel<<<Q, kSelectThreads, smem, st>>>(
        pk, pt, nblk, k, P, (key64*)spill, out_scores, out_ids);
  }
  return (int)cudaGetLastError();
}
