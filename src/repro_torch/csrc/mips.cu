// Top-k maximum inner product search over the valid rows of an index.
//
// Replaces: src/repro/kernels/mips/mips.py::mips_topk_pallas (_mips_kernel).
//
// Two launches (topk.cuh): rows_topk_kernel scores blocks of 8 queries
// against blocks of bn index rows and keeps each query's top-k per row
// block; mips_merge_kernel (one warp per query) merges the survivors.
// Any N works, and the [Q, N] score matrix never reaches device memory.
//
// Bound on this card: at the serving shapes (Q = 64 queries against a
// 4218 x 384 index) 2*Q*N*d fp32 operations, about 0.2 GFLOP (3 us at
// 67 TFLOP/s), against 6.5 MB of index read once (2 us). Design: each
// index row is read from L2 once per block of 8 queries and reused from
// registers; bn is sized so the grid covers the SMs about twice; the
// top-k passes are warp-wide, with no block barrier. Tensor cores are
// not used: the contract is full-fp32 sums.
#include "topk.cuh"

namespace {

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

}  // namespace

extern "C" int mips_rows_per_block(int N, int Q, int k) { return rows_per_block(N, Q, k); }

extern "C" long long mips_smem_bytes(int d, int N, int Q, int k) {
  return (long long)rows_topk_smem(d, rows_per_block(N, Q, k));
}

extern "C" int mips_launch(const float* q, int Q, int d, const float* index, int N,
                           const unsigned char* valid, int k, int bn, float* part_val,
                           int* part_idx, float* out_scores, int* out_ids,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_rows_topk(q, Q, d, index, N, valid, k, bn, part_val,
                                     part_idx, st);
  if (err != cudaSuccess) return (int)err;
  const int m = ((N + bn - 1) / bn) * k;
  mips_merge_kernel<<<(Q * 32 + 255) / 256, 256, 0, st>>>(part_val, part_idx, Q, m, k,
                                                           out_scores, out_ids);
  return (int)cudaGetLastError();
}
