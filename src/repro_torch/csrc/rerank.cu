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
// slot (document id -1) or a -1 route scores NEG_INF. The top-k over the
// nprobe * depth candidates (larger first, lowest position on ties) comes
// back as (score, pos = j * depth + s), pos -1 where the pick is dead. Duplicate
// routes are not merged: a ring routed twice is scored at both j. k may
// exceed one ring's depth and the live count (k <= nprobe * depth); the
// tail is (NEG_INF, -1). The rings may be a depth-clipped strided view
// embs[:, :depth] (ids and scales likewise): they are read through their
// strides, the store is never copied, and pos is encoded with the clipped
// depth.
//
// The TPU kernel runs a (Q, nprobe) grid with a tile-local top-k per ring
// and a separate merge of nprobe * k winners; here a cluster of CS blocks
// serves one query (each scores a share of its candidates and keeps its
// top-k, the leader merges them from distributed shared memory), which is
// the same function.
//
// Bound on this card: bytes. A call reads the queries and each distinct
// routed ring once (depth * d bytes per int8 ring plus its ids and
// scales: about 25 KB at depth 64, d 384), and does 2 * Q * nprobe *
// depth * d fp32 operations, which take less time at 67 TFLOP/s. Design:
// the scoring and the top-k are rings.cuh's (shared with serve.cu, so the
// staged and fused queries score and pick every entry with the same
// arithmetic): 16-byte loads by lane groups with the query in registers,
// composite keys, warp-local top-k, one ranked merge per block and one per
// cluster; a programmatic dependent launch, so its set-up overlaps the
// previous kernel's tail. At the staged flush's shape (64 queries x 8
// routes of int8 depth 64, d 384) the bound is 0.0016 ms; an H100 80GB
// HBM3 at 700 W takes about 0.012 ms (chip_smoke.py; PERF.md).
#include "rings.cuh"

namespace {

__global__ void __launch_bounds__(kRingThreads)
    rerank_kernel(const float* __restrict__ q, int d, int G, const int* __restrict__ routes,
                  int nprobe, int C, RingView rv, int k, float* __restrict__ out_scores,
                  int* __restrict__ out_pos) {
  extern __shared__ __align__(16) unsigned char ring_smem_raw[];
  const int cs = (int)cg::this_cluster().num_blocks();
  const int qi = blockIdx.x / cs;
  const RingSmem L = ring_smem(d, nprobe, rv.depth, k, cs, 0);
  ring_cluster_start(ring_smem_raw, L, nprobe, rv.depth, k);
  float* sq = (float*)(ring_smem_raw + L.sq);
  int* sroutes = (int*)(ring_smem_raw + L.sroutes);
  wait_for_previous_kernel();  // q and routes may come from the kernel just before
  for (int t = threadIdx.x; t < d; t += blockDim.x) sq[t] = q[(size_t)qi * d + t];
  for (int p = threadIdx.x; p < nprobe; p += blockDim.x) {
    const int r = routes[(size_t)qi * nprobe + p];
    sroutes[p] = r < 0 ? -1 : min(r, C - 1);
  }
  __syncthreads();
  float* srow = out_scores + (size_t)qi * k;
  int* prow = out_pos + (size_t)qi * k;
  ring_topk(ring_smem_raw, L, sq, d, G, sroutes, nprobe, rv, k, [&](int t, key64 key) {
    srow[t] = key_score(key);
    prow[t] = pick_pos(key);
  });
}

}  // namespace

extern "C" long long rerank_smem_bytes(int d, int nprobe, int depth, int k, int cs) {
  return (long long)ring_smem(d, nprobe, depth, k, cs, 0).bytes;
}

// cs in {1, 2, 4, 8}: blocks per query.
extern "C" int rerank_launch(const float* q, int Q, int d, const int* routes, int nprobe,
                             int C, const void* embs, int depth, long long es0,
                             long long es1, const int* ids, long long is0,
                             long long is1, const float* scales, long long ss0,
                             long long ss1, int quantized, int k, int cs, float* out_scores,
                             int* out_pos, void* stream) {
  if (cs < 1 || cs > kMaxCluster) return (int)cudaErrorInvalidValue;
  const RingView rv{embs, es0, es1, ids, is0, is1, scales, ss0, ss1, quantized, depth};
  const size_t smem = ring_smem(d, nprobe, depth, k, cs, 0).bytes;
  cudaError_t err = launch_ring(rerank_kernel, Q, cs, smem, (cudaStream_t)stream, q, d,
                                ring_lanes(d, quantized, embs, es0, es1), routes, nprobe, C,
                                rv, k, out_scores, out_pos);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
