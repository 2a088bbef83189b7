// Mean-cosine relevance screen of a microbatch against the topic basis
// (paper §Multi-Vector Cosine Pre-filtering).
//
// Replaces: src/repro/kernels/prefilter/prefilter.py::prefilter_scores_pallas
// (_prefilter_kernel).
//
// r[b] = (1 / n) * sum_i (x_b * rsqrt(max(sum x_b^2, 1e-24))) . v_i, the TPU
// kernel's contract: the basis rows v_i are pre-normalized once per call,
// before the screen (normalize_basis_rows: v * (1 / max(|v|, 1e-12)),
// all-zero rows kept zero, so they add 0), and n is the true number of
// basis rows. The pre-normalization is a first small launch here
// (basis_unit_kernel, sqrtf and an IEEE divide, as the plain
// normalize_basis_rows computes it; the sum runs in another order, so vn
// may differ from it in the last bit).
//
// The rsqrt is rsqrtf, the hardware reciprocal square root (within 2 ulp
// of the correctly rounded value; it is an approximation with or without
// --use_fast_math, which this library does not use). The TPU kernel's
// lax.rsqrt is that hardware's approximation too, so the contract is an
// rsqrt, not a divide; r differs from the plain version (the oracle's
// x / max(sqrt(sum x^2), 1e-12)) in the last bits, and keep = r >= alpha
// follows the near-tie rule at alpha.
//
// Bound on this card: bytes. A call reads x once (B * d * 4 bytes: 393 KB
// at B = 256, d = 384) and the small basis, writes B scores and does
// 2 * B * n * d operations (1 MFLOP); at these sizes the two launches cost
// more than either. Design: one warp per row, 8 rows per block; the row is
// read from device memory once into shared memory, and each basis row
// (read from L1/L2, shared by every block) is one coalesced warp dot.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

// One warp per basis row: vn_i = v_i * (1 / max(|v_i|, 1e-12)), zero rows
// stay zero.
__global__ void basis_unit_kernel(const float* __restrict__ v, int n, int d,
                                  float* __restrict__ vn) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const float* vi = v + (size_t)i * d;
  float ss = 0.f;
  for (int t = lane; t < d; t += 32) ss += vi[t] * vi[t];
  const float norm = sqrtf(warp_sum(ss));
  const float inv = norm > 0.f ? 1.f / fmaxf(norm, 1e-12f) : 0.f;
  for (int t = lane; t < d; t += 32) vn[(size_t)i * d + t] = vi[t] * inv;
}

__global__ void prefilter_kernel(const float* __restrict__ x, int B, int d,
                                 const float* __restrict__ vn, int n,
                                 float* __restrict__ r) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kRowsPerBlock + warp;
  if (b >= B) return;  // warp-uniform; no block barrier follows
  float* sx = smem + (size_t)warp * d;  // each lane reads back only its own t
  const float* xr = x + (size_t)b * d;
  float ss = 0.f;
  for (int t = lane; t < d; t += 32) {
    const float v = xr[t];
    sx[t] = v;
    ss += v * v;
  }
  const float xinv = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    const float* vi = vn + (size_t)i * d;
    float p = 0.f;
    for (int t = lane; t < d; t += 32) p += (sx[t] * xinv) * vi[t];
    acc += warp_sum(p);
  }
  if (lane == 0) r[b] = acc / (float)n;
}

}  // namespace

extern "C" long long prefilter_smem_bytes(int d) {
  return (long long)kRowsPerBlock * d * sizeof(float);
}

// basis [n, d] raw; vn [n, d] is the caller's workspace for its unit rows.
extern "C" int prefilter_launch(const float* x, int B, int d, const float* basis,
                                int n, float* vn, float* r, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)prefilter_smem_bytes(d);
  cudaError_t err = allow_smem(prefilter_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  basis_unit_kernel<<<(n + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0,
                      st>>>(basis, n, d, vn);
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  prefilter_kernel<<<blocks, 32 * kRowsPerBlock, smem, st>>>(x, B, d, vn, n, r);
  return (int)cudaGetLastError();
}
