// Fused ingest admission for one microbatch (paper Algorithm 1, steps 1-3).
//
// Replaces: src/repro/kernels/admit/admit.py::admit_pallas (_admit_kernel).
//
// Per row of x [B, d] it emits the prefilter score r (mean cosine against
// the host-normalized basis), keep = (r >= alpha) & live, the nearest
// centroid (label, cosine) with ties to the lowest index, and the
// ring-write-ready row: unit (or raw) fp32, or symmetric int8 plus a per-row
// fp32 scale. Normalization is the reference's exact sequence
// x / max(sqrt(sum x^2), 1e-12): IEEE divide and sqrt (this library is built
// without --use_fast_math), so int8 rows and scales follow the plain version.
//
// Bound on this card: the centroid scan is 2*B*K*d fp32 operations against
// B*d + K*d words read, so at B=256 it is bound by fp32 operations, not
// bytes (about 0.83 GFLOP, 12 us at 67 TFLOP/s). Design: four launches on
// the caller's stream. (1) one warp per centroid writes the unit centroid
// c / max(|c|, 1e-12) — the reference's exact elementwise divide — to a
// scratch buffer, once per call; (2) one block per row does all row-only
// work (norm, screen, keep, quantize) and writes the unit row to a scratch
// buffer; (3) a register-blocked SGEMM-style tile kernel computes the
// cosines of 64 rows x 64 centroids per block (each staged element feeds 4
// FMAs from registers, 264 blocks at B=256, K=4218) and keeps each row's
// (max, lowest index) per tile; (4) a per-row merge over the K/64 tiles
// keeps the lowest index on ties.
// No tensor cores yet: wgmma in fp32 has no full-precision path, and the
// keep/label contract is with full-fp32 sums.
#include "common.cuh"

namespace {

constexpr int kTile = 64;   // rows and centroids per assign tile
constexpr int kTileK = 32;  // components staged per step

__global__ void centroid_unit_kernel(const float* __restrict__ c, int K, int d,
                                     float* __restrict__ cn) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= K) return;  // warp-uniform
  const float* row = c + (size_t)j * d;
  float ss = 0.f;
  for (int t = lane; t < d; t += 32) {
    const float v = row[t];
    ss += v * v;
  }
  const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
  for (int t = lane; t < d; t += 32) cn[(size_t)j * d + t] = row[t] / nrm;
}

__global__ void admit_rows_kernel(const float* __restrict__ x, int d,
                                  const float* __restrict__ basis, int n,
                                  const unsigned char* __restrict__ live,
                                  float alpha, int emit_rows, int quantized,
                                  int normalize, float* __restrict__ r_out,
                                  unsigned char* __restrict__ keep_out,
                                  void* __restrict__ row_out,
                                  float* __restrict__ scale_out,
                                  float* __restrict__ xn_out) {
  extern __shared__ float smem[];
  float* sx = smem;            // [d] raw row
  float* sxn = smem + d;       // [d] unit row
  float* scratch = smem + 2 * d;
  const int b = blockIdx.x;
  const float* xr = x + (size_t)b * d;

  float ss = 0.f;
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    const float v = xr[t];
    sx[t] = v;
    ss += v * v;
  }
  ss = block_sum(ss, scratch);
  const float nrm = fmaxf(sqrtf(ss), 1e-12f);
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    const float v = sx[t] / nrm;
    sxn[t] = v;
    xn_out[(size_t)b * d + t] = v;
  }
  __syncthreads();

  // prefilter screen: mean over the n basis rows of cos(x, v_i)
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    const float* vi = basis + (size_t)i * d;
    float p = 0.f;
    for (int t = threadIdx.x; t < d; t += blockDim.x) p += sxn[t] * vi[t];
    acc += block_sum(p, scratch);
  }
  const float r = acc / (float)n;
  if (threadIdx.x == 0) {
    r_out[b] = r;
    keep_out[b] = (r >= alpha && live[b] != 0) ? 1 : 0;
  }
  if (!emit_rows) return;

  const float* v = normalize ? sxn : sx;
  if (quantized) {
    float amax = 0.f;
    for (int t = threadIdx.x; t < d; t += blockDim.x) amax = fmaxf(amax, fabsf(v[t]));
    amax = block_max(amax, scratch);
    const float scale = fmaxf(amax, 1e-12f) / 127.0f;
    signed char* q = (signed char*)row_out + (size_t)b * d;
    for (int t = threadIdx.x; t < d; t += blockDim.x) {
      const float z = fminf(fmaxf(rintf(v[t] / scale), -127.f), 127.f);
      q[t] = (signed char)z;
    }
    if (threadIdx.x == 0) scale_out[b] = scale;
  } else {
    float* o = (float*)row_out + (size_t)b * d;
    for (int t = threadIdx.x; t < d; t += blockDim.x) o[t] = v[t];
    if (threadIdx.x == 0) scale_out[b] = 1.0f;
  }
}

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

}  // namespace

extern "C" int admit_launch(const float* x, int B, int d, const float* basis, int n,
                            const float* centroids, int K,
                            const unsigned char* live, float alpha, int emit_rows,
                            int quantized, int normalize, float* r,
                            unsigned char* keep, int* label, float* sim, void* row,
                            float* scale, float* xn_scratch, float* cn_scratch,
                            float* part_val, int* part_idx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;

  const int norm_threads = 256;
  const int norm_blocks = (K * 32 + norm_threads - 1) / norm_threads;
  centroid_unit_kernel<<<norm_blocks, norm_threads, 0, st>>>(centroids, K, d,
                                                             cn_scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t rows_smem = (size_t)(2 * d + REPRO_RED_SLOTS) * sizeof(float);
  if ((err = allow_smem(admit_rows_kernel, rows_smem)) != cudaSuccess) return (int)err;
  admit_rows_kernel<<<B, 128, rows_smem, st>>>(x, d, basis, n, live, alpha, emit_rows,
                                               quantized, normalize, r, keep, row,
                                               scale, xn_scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int splits = (K + kTile - 1) / kTile;
  dim3 grid((B + kTile - 1) / kTile, splits);
  assign_tile_kernel<<<grid, 256, 0, st>>>(xn_scratch, B, d, cn_scratch, K, part_val,
                                           part_idx);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  assign_merge_kernel<<<(B + 255) / 256, 256, 0, st>>>(part_val, part_idx, B, splits,
                                                       label, sim);
  return (int)cudaGetLastError();
}
