// The whole two-stage query: route -> gather -> dequant-rerank -> top-k.
//
// Replaces: src/repro/kernels/serve/serve.py::serve_topk_pallas (_serve_kernel).
//
// Two launches. (1) rows_topk_kernel (topk.cuh) scores blocks of 8 queries
// against chunks of the prototype index in shared memory (invalid slots at
// NEG_INF) and keeps each query's top-nprobe slots per chunk; the
// [Q, cap] route-score matrix never reaches device memory. (2) One block
// per query: warp 0 merges the chunk survivors into the top-nprobe slots
// (lowest slot among equals) and maps them through route_labels (a dead
// slot or score gives route -1); all warps then gather each routed ring by
// plain pointer arithmetic over the ring's strides — a depth-clipped view
// embs[:, :depth] is read in place, never copied — widen int8 to fp32,
// score (q . e) * scale, and put NEG_INF on dead slots and dead routes;
// warp 0 takes the top-k over the nprobe * depth candidates (lowest
// position on ties); pos = j*depth+slot, -1 where dead. The scoring and
// the top-k are rings.cuh's, shared with the rerank kernel.
//
// Bound on this card: bytes. A call must read the queries, the index
// (6.5 MB at cap 4218) and the distinct routed rings (depth * d bytes
// each for int8); its arithmetic, 2*Q*(cap + nprobe*depth)*d fp32
// operations, takes less time at 67 TFLOP/s. Design: the index is read
// from L2 once per 8 queries; the routed rings, the bytes that grow with
// the store, are read once per query, coalesced along d.
#include "rings.cuh"
#include "topk.cuh"

namespace {

__global__ void serve_rerank_kernel(
    const float* __restrict__ qn, int d, const float* __restrict__ part_val,
    const int* __restrict__ part_idx, int m, const int* __restrict__ route_labels,
    const void* embs, long long es0, long long es1, const unsigned char* __restrict__ live,
    long long ls0, long long ls1, const float* __restrict__ scales, long long ss0,
    long long ss1, int quantized, int depth, int k, int nprobe,
    float* __restrict__ out_scores, int* __restrict__ out_pos,
    int* __restrict__ out_routes) {
  extern __shared__ float smem[];
  const int ncand = nprobe * depth;
  float* sqn = smem;               // [d]
  float* cand = sqn + d;           // [nprobe * depth] candidate scores
  float* pv = cand + ncand;        // [m] route survivors
  int* pi = (int*)(pv + m);        // [m]
  int* sroutes = pi + m;           // [nprobe]
  const int qi = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < d; t += blockDim.x) sqn[t] = qn[(size_t)qi * d + t];
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    pv[c] = part_val[(size_t)qi * m + c];
    pi[c] = part_idx[(size_t)qi * m + c];
  }
  __syncthreads();

  // ---- top-nprobe slots -> clusters
  if (warp == 0) {
    int* orow = out_routes + (size_t)qi * nprobe;
    topk_merge_warp(pv, pi, m, nprobe, [&](int p, float v, int slot) {
      const int lbl = route_labels[slot];
      const int route = (v > REPRO_NEG_INF / 2 && lbl >= 0) ? lbl : -1;
      sroutes[p] = route;
      orow[p] = route;
    });
  }
  __syncthreads();

  // ---- gather + score the routed rings, warp per ring slot
  score_routed_rings(sqn, d, sroutes, nprobe, depth, embs, es0, es1, live, ls0, ls1,
                     scales, ss0, ss1, quantized, cand);
  __syncthreads();

  // ---- top-k over the candidates
  if (warp != 0) return;
  candidates_topk_warp(cand, ncand, k, out_scores + (size_t)qi * k,
                       out_pos + (size_t)qi * k);
}

size_t rerank_smem(int d, int m, int nprobe, int depth) {
  return (size_t)(d + nprobe * depth + m) * sizeof(float) +
         (size_t)(m + nprobe) * sizeof(int);
}

}  // namespace

extern "C" int serve_rows_per_block(int cap, int Q, int nprobe) {
  return rows_per_block(cap, Q, nprobe);
}

extern "C" long long serve_smem_bytes(int d, int cap, int Q, int nprobe, int depth) {
  const int bn = rows_per_block(cap, Q, nprobe);
  const size_t a = rows_topk_smem(d, bn);
  const size_t b = rerank_smem(d, ((cap + bn - 1) / bn) * nprobe, nprobe, depth);
  return (long long)(a > b ? a : b);
}

extern "C" int serve_launch(const float* qr, const float* qn, int Q, int d,
                            const float* vectors, int cap, const unsigned char* valid,
                            const int* route_labels, const void* embs, int depth,
                            long long es0, long long es1, const unsigned char* live,
                            long long ls0, long long ls1, const float* scales,
                            long long ss0, long long ss1, int quantized, int k,
                            int nprobe, int bn, float* part_val, int* part_idx,
                            float* out_scores, int* out_pos, int* out_routes,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_rows_topk(qr, Q, d, vectors, cap, valid, nprobe, bn,
                                     part_val, part_idx, st);
  if (err != cudaSuccess) return (int)err;
  const int m = ((cap + bn - 1) / bn) * nprobe;
  const size_t smem = rerank_smem(d, m, nprobe, depth);
  if ((err = allow_smem(serve_rerank_kernel, smem)) != cudaSuccess) return (int)err;
  serve_rerank_kernel<<<Q, 256, smem, st>>>(qn, d, part_val, part_idx, m, route_labels,
                                            embs, es0, es1, live, ls0, ls1, scales, ss0,
                                            ss1, quantized, depth, k, nprobe, out_scores,
                                            out_pos, out_routes);
  return (int)cudaGetLastError();
}
