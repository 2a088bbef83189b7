// Nearest centroid by cosine for a microbatch (paper §Clustering & Label
// Assignment).
//
// Replaces: src/repro/kernels/assign/assign.py::assign_pallas (_assign_kernel).
//
// best_id[b] = argmax_j (x_b * rsqrt(max(sum x_b^2, 1e-24))) .
//                       (c_j * rsqrt(max(sum c_j^2, 1e-24))),
// fp32 dots, ties to the lowest j; best_sim[b] is that maximum. This is
// the TPU kernel's rsqrt normalization of both the rows and the centroids
// (rsqrtf, the hardware reciprocal square root, within 2 ulp; the TPU's
// lax.rsqrt is an approximation too), not the divide form of the plain
// version or of the admit kernel, so sims differ from the plain version in
// the last bits and labels follow the near-tie rule.
//
// Bound on this card: operations. At B = 256 rows against K = 4218
// centroids of d = 384 the scan is 2 * B * K * d = 0.83 GFLOP of fp32
// (12.4 us at 67 TFLOP/s) against 8.1 MB read (2.4 us at 3.35 TB/s).
// Design: three launches on the caller's stream. (1) One warp per row
// writes the unit rows of x and of the centroids, in one launch over
// B + K rows, to scratch. (2) assign_tiles.cuh's register-blocked
// 64 x 64 cosine tile kernel (shared with admit.cu; 264 blocks at B = 256)
// keeps each row's (max, lowest index) per tile of 64 centroids, so the
// [B, K] similarity matrix never reaches device memory; K need not be a
// multiple of 64, and columns past K never win. (3) A per-row merge over
// the ceil(K / 64) partials. No tensor cores: the contract is full-fp32
// sums.
#include "assign_tiles.cuh"

namespace {

// Rows [0, B) of x then rows [0, K) of c, each to v * rsqrt(max(|v|^2, 1e-24)).
__global__ void unit_rows_rsqrt_kernel(const float* __restrict__ x, int B,
                                       const float* __restrict__ c, int K, int d,
                                       float* __restrict__ xn, float* __restrict__ cn) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= B + K) return;  // warp-uniform
  const float* src = j < B ? x + (size_t)j * d : c + (size_t)(j - B) * d;
  float* dst = j < B ? xn + (size_t)j * d : cn + (size_t)(j - B) * d;
  float ss = 0.f;
  for (int t = lane; t < d; t += 32) {
    const float v = src[t];
    ss += v * v;
  }
  const float inv = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
  for (int t = lane; t < d; t += 32) dst[t] = src[t] * inv;
}

}  // namespace

extern "C" int assign_splits(int K) { return (K + kTile - 1) / kTile; }

extern "C" int assign_launch(const float* x, int B, int d, const float* centroids, int K,
                             int* best_id, float* best_sim, float* xn_scratch,
                             float* cn_scratch, float* part_val, int* part_idx,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const int blocks = (int)(((long long)(B + K) * 32 + threads - 1) / threads);
  unit_rows_rsqrt_kernel<<<blocks, threads, 0, st>>>(x, B, centroids, K, d, xn_scratch,
                                                     cn_scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_assign_tiles(xn_scratch, B, d, cn_scratch, K, part_val, part_idx,
                                  best_id, best_sim, st);
}
