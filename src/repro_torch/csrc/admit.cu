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
// bytes (about 0.83 GFLOP, 12 us at 67 TFLOP/s). Design: three launches on
// the caller's stream. (1) one warp per centroid writes the unit centroid
// c / max(|c|, 1e-12) — the reference's exact elementwise divide — to a
// scratch buffer, once per call, and zeroes the merge keys; (2) one block
// per row does all row-only work (norm, screen, keep, quantize) and writes
// the unit row to a scratch buffer; (3) assign_tiles.cuh's register-blocked
// tile kernel (shared with the assign kernel) computes the cosines of 64
// rows x 64 centroids per block (an 8 x 4 block per thread, 264 blocks at
// B=256, K=4218), folds each row's (max, lowest index) per tile into a
// 64-bit atomicMax key, and its last block decodes the keys into labels
// and sims.
// No tensor cores yet: wgmma in fp32 has no full-precision path, and the
// keep/label contract is with full-fp32 sums.
#include "assign_tiles.cuh"

namespace {

__global__ void centroid_unit_kernel(const float* __restrict__ c, int K, int d,
                                     float* __restrict__ cn, int B,
                                     key64* __restrict__ keys, unsigned* __restrict__ done) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  init_assign_keys(keys, done, B, gid, (long long)gridDim.x * blockDim.x);
  const int j = (int)(gid >> 5);
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

}  // namespace

extern "C" int admit_launch(const float* x, int B, int d, const float* basis, int n,
                            const float* centroids, int K,
                            const unsigned char* live, float alpha, int emit_rows,
                            int quantized, int normalize, float* r,
                            unsigned char* keep, int* label, float* sim, void* row,
                            float* scale, float* xn_scratch, float* cn_scratch,
                            void* keys, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  key64* k64 = (key64*)keys;  // B merge keys, then the done counter
  unsigned* done = (unsigned*)(k64 + B);

  const int norm_threads = 256;
  const int norm_blocks = (K * 32 + norm_threads - 1) / norm_threads;
  centroid_unit_kernel<<<norm_blocks, norm_threads, 0, st>>>(centroids, K, d,
                                                             cn_scratch, B, k64, done);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t rows_smem = (size_t)(2 * d + REPRO_RED_SLOTS) * sizeof(float);
  if ((err = allow_smem(admit_rows_kernel, rows_smem)) != cudaSuccess) return (int)err;
  admit_rows_kernel<<<B, 128, rows_smem, st>>>(x, d, basis, n, live, alpha, emit_rows,
                                               quantized, normalize, r, keep, row,
                                               scale, xn_scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  return (int)launch_assign_tiles(xn_scratch, B, d, cn_scratch, K, k64, done, label,
                                  sim, st);
}
