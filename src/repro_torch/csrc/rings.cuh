// Scoring of routed ring-buffer entries and the per-query top-k over
// them, shared by the serve kernel (after its fused route) and the rerank
// kernel (routes given), so the two score every entry with the same
// arithmetic.
//
// A block serves one query. Candidate c = p * depth + s is slot s of the
// query's p-th route; a ring is read by pointer arithmetic over the given
// element strides, so a depth-clipped view embs[:, :depth] is read in
// place and never copied.
#pragma once

#include "common.cuh"

// All warps of the block, warp per candidate: cand[c] = (q . e) * scale
// in fp32 (the dot first, then the int8 slot's scale), NEG_INF where the
// slot is dead or the route is -1. sqn [d] and sroutes [nprobe] are in
// shared memory; routes are already clamped to the store's clusters.
__device__ __forceinline__ void score_routed_rings(
    const float* sqn, int d, const int* sroutes, int nprobe, int depth,
    const void* embs, long long es0, long long es1,
    const unsigned char* __restrict__ live, long long ls0, long long ls1,
    const float* __restrict__ scales, long long ss0,
    long long ss1, int quantized, float* cand) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int ncand = nprobe * depth;
  for (int c = warp; c < ncand; c += nw) {
    const int p = c / depth, s = c - p * depth;
    const int route = sroutes[p];
    float val = REPRO_NEG_INF;
    if (route >= 0) {
      float acc = 0.f;
      if (quantized) {
        const signed char* e = (const signed char*)embs + route * es0 + s * es1;
        for (int t = lane; t < d; t += 32) acc += sqn[t] * (float)e[t];
      } else {
        const float* e = (const float*)embs + route * es0 + s * es1;
        for (int t = lane; t < d; t += 32) acc += sqn[t] * e[t];
      }
      acc = warp_sum(acc);
      if (quantized) acc = acc * scales[route * ss0 + s * ss1];
      val = live[route * ls0 + s * ls1] ? acc : REPRO_NEG_INF;
    }
    if (lane == 0) cand[c] = val;
  }
}

// One warp: the top-k of cand[ncand] (larger first, lowest position on
// ties) into one query's output rows; pos is -1 where the pick is dead.
// Picks are retired in place, so cand is consumed. k <= ncand.
__device__ __forceinline__ void candidates_topk_warp(float* cand, int ncand, int k,
                                                     float* out_scores, int* out_pos) {
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = lane; c < ncand; c += 32) {
      const float v = cand[c];
      if (better(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      out_scores[t] = bv;
      out_pos[t] = bv > REPRO_NEG_INF / 2 ? bi : -1;
      cand[bi] = -INFINITY;
    }
    __syncwarp();
  }
}
