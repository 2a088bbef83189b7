// Blocked top-k inner products, shared by the mips and serve kernels.
//
// rows_topk_kernel: grid (N / bn, Q / kQueriesPerBlock). A block keeps
// kQueriesPerBlock queries in shared memory and scores them against bn
// index rows (warp per row: each row is read from L2 once for all the
// block's queries), invalid rows at NEG_INF, rows past N at -inf. Then
// warp w extracts query w's top-k of the bn scores by k warp-wide passes
// of (max, lowest row among equals) — no block barrier inside the loop —
// and writes them to part_val/part_idx [Q, N / bn, k].
//
// The global top-k under (score desc, row asc) is a subset of the
// per-block top-k's under the same order, so merging the survivors
// (topk_merge_warp) is exact, ties included.
#pragma once

#include "common.cuh"

constexpr int kQueriesPerBlock = 8;  // one warp per query in the top-k pass

// (value, index, position) warp argmax: the position rides along so the
// winner can be retired where it lies.
__device__ __forceinline__ void warp_argmax_pos(float& v, int& i, int& c) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(REPRO_FULL_MASK, v, o);
    const int oi = __shfl_xor_sync(REPRO_FULL_MASK, i, o);
    const int oc = __shfl_xor_sync(REPRO_FULL_MASK, c, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
      c = oc;
    }
  }
}

__global__ void rows_topk_kernel(const float* __restrict__ q, int Q, int d,
                                 const float* __restrict__ rows, int N,
                                 const unsigned char* __restrict__ valid, int k,
                                 int bn, float* __restrict__ part_val,
                                 int* __restrict__ part_idx) {
  extern __shared__ float smem[];
  constexpr int QB = kQueriesPerBlock;
  float* sq = smem;          // [QB, d]
  float* s = sq + QB * d;    // [QB, bn]
  const int q0 = blockIdx.y * QB, base = blockIdx.x * bn, nblk = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int e = threadIdx.x; e < QB * d; e += blockDim.x) {
    const int qq = e / d;
    sq[e] = q0 + qq < Q ? q[(size_t)(q0 + qq) * d + (e - qq * d)] : 0.f;
  }
  __syncthreads();

  for (int j = warp; j < bn; j += nw) {
    const int g = base + j;
    float acc[QB];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) acc[qq] = 0.f;
    if (g < N) {
      const float* row = rows + (size_t)g * d;
      for (int t = lane; t < d; t += 32) {
        const float r = row[t];
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) acc[qq] += sq[qq * d + t] * r;
      }
    }
    const bool ok = g < N && valid[g];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) {
      const float v = warp_sum(acc[qq]);
      if (lane == 0) s[qq * bn + j] = g >= N ? -INFINITY : (ok ? v : REPRO_NEG_INF);
    }
  }
  __syncthreads();

  const int qi = q0 + warp;
  if (warp >= QB || qi >= Q) return;  // warp-uniform: no barrier follows
  float* sw = s + warp * bn;
  float* pv = part_val + ((size_t)qi * nblk + blockIdx.x) * k;
  int* pi = part_idx + ((size_t)qi * nblk + blockIdx.x) * k;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT_MAX, bc = 0;
    for (int j = lane; j < bn; j += 32) {
      const float v = sw[j];
      if (better(v, base + j, bv, bi)) {
        bv = v;
        bi = base + j;
        bc = j;
      }
    }
    warp_argmax_pos(bv, bi, bc);
    if (lane == 0) {
      pv[t] = bv;
      pi[t] = bi;
      sw[bc] = -INFINITY;
    }
    __syncwarp();
  }
}

// One warp merges m (value, index) survivors into the top-k, retiring each
// pick in place (`val` is scratch). Lane 0 receives the picks through
// `emit(t, value, index)`.
template <typename Emit>
__device__ void topk_merge_warp(float* val, const int* idx, int m, int k, Emit emit) {
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT_MAX, bc = 0;
    for (int c = lane; c < m; c += 32) {
      const float v = val[c];
      const int i = idx[c];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
        bc = c;
      }
    }
    warp_argmax_pos(bv, bi, bc);
    if (lane == 0) {
      emit(t, bv, bi);
      val[bc] = -INFINITY;
    }
    __syncwarp();
  }
}

// Rows per block so the grid covers the card about twice: a multiple of 32,
// at least k (a block must hold k survivors).
static int rows_per_block(int N, int Q, int k) {
  const int qblocks = (Q + kQueriesPerBlock - 1) / kQueriesPerBlock;
  int bn = (int)(((long long)N * qblocks + 263) / 264);
  bn = ((bn + 31) / 32) * 32;
  if (bn < 64) bn = 64;
  if (bn < k) bn = ((k + 31) / 32) * 32;
  return bn;
}

static size_t rows_topk_smem(int d, int bn) {
  return (size_t)kQueriesPerBlock * (d + bn) * sizeof(float);
}

// Launches rows_topk_kernel; the caller allocated part_* as [Q, nblk * k]
// with nblk = ceil(N / bn).
static cudaError_t launch_rows_topk(const float* q, int Q, int d, const float* rows,
                                    int N, const unsigned char* valid, int k, int bn,
                                    float* part_val, int* part_idx, cudaStream_t st) {
  const size_t smem = rows_topk_smem(d, bn);
  cudaError_t err = allow_smem(rows_topk_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + bn - 1) / bn, (Q + kQueriesPerBlock - 1) / kQueriesPerBlock);
  rows_topk_kernel<<<grid, 32 * kQueriesPerBlock, smem, st>>>(q, Q, d, rows, N, valid,
                                                              k, bn, part_val, part_idx);
  return cudaGetLastError();
}
