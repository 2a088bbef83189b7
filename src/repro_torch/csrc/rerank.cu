// Exact top-k over each query's routed ring buffers (stage 2 of the
// staged two-stage query: routes come from the prototype index).
//
// Replaces: src/repro/kernels/rerank/rerank.py::rerank_topk_pallas
// (_rerank_kernel).
//
// Per query i and route j (routes [Q, nprobe], -1 = no route; a route is
// clamped to the store's last cluster as the plain version clamps it),
// every slot s of ring routes[i, j] scores (q_i . e) * scale in fp32 (the
// dot first, then the int8 slot's scale; fp32 rings carry none); a dead
// slot or a -1 route scores NEG_INF. The top-k over the nprobe * depth
// candidates (larger first, lowest position on ties) comes back as
// (score, pos = j * depth + s), pos -1 where the pick is dead. Duplicate
// routes are not merged: a ring routed twice is scored at both j. k may
// exceed one ring's depth and the live count (k <= nprobe * depth); the
// tail is (NEG_INF, -1). The rings may be a depth-clipped strided view
// embs[:, :depth] (live and scales likewise): they are read through their
// strides, the store is never copied, and pos is encoded with the clipped
// depth.
//
// The TPU kernel runs a (Q, nprobe) grid with a tile-local top-k per ring
// and a separate merge of nprobe * k winners; here one block serves one
// query and takes its top-k once over all its candidates, which is the
// same function.
//
// Bound on this card: bytes. A call reads the queries and each distinct
// routed ring once (depth * d bytes per int8 ring plus its live flags and
// scales: about 25 KB at depth 64, d 384), and does 2 * Q * nprobe *
// depth * d fp32 operations, which take less time at 67 TFLOP/s. Design:
// the scoring and the top-k are rings.cuh's (shared with serve.cu, so the
// staged and fused queries score every entry with the same arithmetic):
// warp per candidate, coalesced along d, the query and the candidate
// scores in shared memory, then one warp extracts the top-k.
#include "rings.cuh"

namespace {

__global__ void rerank_kernel(const float* __restrict__ q, int d,
                              const int* __restrict__ routes, int nprobe, int C,
                              const void* embs, long long es0, long long es1,
                              const unsigned char* __restrict__ live, long long ls0,
                              long long ls1, const float* __restrict__ scales,
                              long long ss0, long long ss1, int quantized, int depth,
                              int k, float* __restrict__ out_scores,
                              int* __restrict__ out_pos) {
  extern __shared__ float smem[];
  const int ncand = nprobe * depth;
  float* sqn = smem;                     // [d]
  float* cand = sqn + d;                 // [nprobe * depth] candidate scores
  int* sroutes = (int*)(cand + ncand);   // [nprobe]
  const int qi = blockIdx.x;
  for (int t = threadIdx.x; t < d; t += blockDim.x) sqn[t] = q[(size_t)qi * d + t];
  for (int p = threadIdx.x; p < nprobe; p += blockDim.x) {
    const int r = routes[(size_t)qi * nprobe + p];
    sroutes[p] = r < 0 ? -1 : min(r, C - 1);
  }
  __syncthreads();

  score_routed_rings(sqn, d, sroutes, nprobe, depth, embs, es0, es1, live, ls0, ls1,
                     scales, ss0, ss1, quantized, cand);
  __syncthreads();

  if ((threadIdx.x >> 5) != 0) return;
  candidates_topk_warp(cand, ncand, k, out_scores + (size_t)qi * k,
                       out_pos + (size_t)qi * k);
}

}  // namespace

extern "C" long long rerank_smem_bytes(int d, int nprobe, int depth) {
  return (long long)(d + nprobe * depth) * sizeof(float) +
         (long long)nprobe * sizeof(int);
}

extern "C" int rerank_launch(const float* q, int Q, int d, const int* routes, int nprobe,
                             int C, const void* embs, int depth, long long es0,
                             long long es1, const unsigned char* live, long long ls0,
                             long long ls1, const float* scales, long long ss0,
                             long long ss1, int quantized, int k, float* out_scores,
                             int* out_pos, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)rerank_smem_bytes(d, nprobe, depth);
  cudaError_t err = allow_smem(rerank_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rerank_kernel<<<Q, 256, smem, st>>>(q, d, routes, nprobe, C, embs, es0, es1, live,
                                      ls0, ls1, scales, ss0, ss1, quantized, depth, k,
                                      out_scores, out_pos);
  return (int)cudaGetLastError();
}
