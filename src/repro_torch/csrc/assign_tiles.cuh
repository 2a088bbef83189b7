// Nearest centroid over pre-normalized rows, shared by the admit and
// assign kernels: a register-blocked cosine tile kernel writing per-tile
// (max, lowest index) partials, and a per-row merge of the partials.
//
// Ties go to the lowest centroid index everywhere: a thread keeps its
// first strict maximum over its columns in ascending order, and the
// shuffle and the merge compare (value, index) with `better`. Columns past
// K are never candidates, so a padded tile column never wins.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTile = 64;   // rows and centroids per assign tile
constexpr int kTileK = 32;  // components staged per step

// Cosines of a 64-row x 64-centroid tile, register-blocked like an SGEMM:
// the tile's rows and centroids are staged in shared memory 32 components
// at a time, and each thread accumulates a 4 x 4 block in registers (fp32
// FMAs over d in order). Then each row's (max, lowest index) over the
// tile's centroids goes to part_val/part_idx [K / 64, B].
__global__ void assign_tile_kernel(const float* __restrict__ xn, int B, int d,
                                   const float* __restrict__ cn, int K,
                                   float* __restrict__ part_val,
                                   int* __restrict__ part_idx) {
  // transposed tiles, padded so the staging stores hit distinct banks
  __shared__ float xs[kTileK][kTile + 1];
  __shared__ float cs[kTileK][kTile + 1];
  const int tid = threadIdx.x;  // 256 threads: 16 x 16 blocks of 4 x 4
  const int tr = tid >> 4, tc = tid & 15;
  const int row0 = blockIdx.x * kTile, col0 = blockIdx.y * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kTileK) {
    for (int e = tid; e < kTile * kTileK; e += blockDim.x) {
      const int r = e / kTileK, kk = e - r * kTileK, gk = k0 + kk;
      xs[kk][r] = (row0 + r < B && gk < d) ? xn[(size_t)(row0 + r) * d + gk] : 0.f;
      cs[kk][r] = (col0 + r < K && gk < d) ? cn[(size_t)(col0 + r) * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][tr * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = cs[kk][tc * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // per row: (max, lowest centroid) over this thread's 4 columns, then over
  // the 16 threads (16 consecutive lanes) that share the row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tc * 4 + j;
      if (c < K && acc[i][j] > bv) {
        bv = acc[i][j];
        bi = c;
      }
    }
    for (int o = 8; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(REPRO_FULL_MASK, bv, o);
      const int oi = __shfl_xor_sync(REPRO_FULL_MASK, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int row = row0 + tr * 4 + i;
    if (tc == 0 && row < B) {
      part_val[(size_t)blockIdx.y * B + row] = bv;
      part_idx[(size_t)blockIdx.y * B + row] = bi;
    }
  }
}

__global__ void assign_merge_kernel(const float* __restrict__ part_val,
                                    const int* __restrict__ part_idx, int B,
                                    int splits, int* __restrict__ label,
                                    float* __restrict__ sim) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int s = 0; s < splits; ++s) {
    const float v = part_val[(size_t)s * B + b];
    const int i = part_idx[(size_t)s * B + b];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  label[b] = bi;
  sim[b] = bv;
}

// Launches the tile kernel and the merge on unit rows xn [B, d] and unit
// centroids cn [K, d]; part_val/part_idx hold [ceil(K / 64), B] partials.
static cudaError_t launch_assign_tiles(const float* xn, int B, int d, const float* cn,
                                       int K, float* part_val, int* part_idx, int* label,
                                       float* sim, cudaStream_t st) {
  const int splits = (K + kTile - 1) / kTile;
  dim3 grid((B + kTile - 1) / kTile, splits);
  assign_tile_kernel<<<grid, 256, 0, st>>>(xn, B, d, cn, K, part_val, part_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  assign_merge_kernel<<<(B + 255) / 256, 256, 0, st>>>(part_val, part_idx, B, splits,
                                                       label, sim);
  return cudaGetLastError();
}

}  // namespace
