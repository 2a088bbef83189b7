// Mean-cosine relevance screen of a microbatch against the topic basis
// (paper §Multi-Vector Cosine Pre-filtering).
//
// Replaces: src/repro/kernels/prefilter/prefilter.py::prefilter_scores_pallas
// (_prefilter_kernel).
//
// r[b] = (1 / n) * sum_i (x_b * rsqrt(max(sum x_b^2, 1e-24))) . v_i, the TPU
// kernel's contract: the basis rows v_i are normalized before the screen
// (normalize_basis_rows: v * (1 / max(|v|, 1e-12)), all-zero rows kept
// zero, so they add 0; sqrtf and an IEEE divide; the sum runs in another
// order than the plain version's, so a unit basis row may differ from it in
// the last bit), and n is the true number of basis rows.
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
// 2 * B * n * d operations (1 MFLOP); at these sizes one launch costs more
// than either. Design: one launch. Every block normalizes the n basis rows
// into its own shared memory (n * d floats read from L2, a warp a row),
// then each warp takes one row of x, held in registers (16-byte loads where
// d % 4 == 0 and x is aligned, 3 float4 a lane at d = 384; 4-byte loads
// otherwise; rows longer than 512 floats are read again instead), and does
// n warp dots against the shared basis. The rows a block takes are the
// wrapper's plan (kernels/prefilter/prefilter.py::prefilter_plan).
#include "common.cuh"

namespace {

constexpr int kMaxHeld = 4;  // chunks of 4 floats a lane holds (d <= 512)

template <int NV, bool VEC>
__global__ void prefilter_kernel(const float* __restrict__ x, int B, int d,
                                 const float* __restrict__ basis, int n,
                                 float* __restrict__ r) {
  extern __shared__ __align__(16) float svn[];  // [n][d] unit basis rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.x * warps + warp;
  // the warp's row (a warp past B rereads row B - 1 and stops): its loads
  // are in flight while the basis is normalized
  WarpRow<NV, VEC> row(x + (size_t)min(b, B - 1) * d, d, lane);
  // vn_i = v_i * (1 / max(|v_i|, 1e-12)), zero rows stay zero
  for (int i = warp; i < n; i += warps) {
    const float* vi = basis + (size_t)i * d;
    float ss = 0.f;
    for (int t = lane; t < d; t += 32) ss += vi[t] * vi[t];
    const float norm = sqrtf(warp_sum(ss));
    const float inv = norm > 0.f ? 1.f / fmaxf(norm, 1e-12f) : 0.f;
    for (int t = lane; t < d; t += 32) svn[(size_t)i * d + t] = vi[t] * inv;
  }
  const float xinv = rsqrtf(fmaxf(warp_sum(row.sumsq()), 1e-24f));
  __syncthreads();
  if (b >= B) return;  // warp-uniform; no barrier follows
  const float acc = screen_sum(row, svn, n, d, lane, xinv);
  if (lane == 0) r[b] = acc / (float)n;
}

using PrefilterKernel = decltype(&prefilter_kernel<1, true>);

// The instantiation for rows of d floats: NV = ceil(d / 128) chunks a lane
// held in registers, or 0 (reread) past kMaxHeld.
PrefilterKernel prefilter_for(int d, bool vec) {
  static const PrefilterKernel held_vec[] = {
      prefilter_kernel<0, true>, prefilter_kernel<1, true>, prefilter_kernel<2, true>,
      prefilter_kernel<3, true>, prefilter_kernel<4, true>};
  static const PrefilterKernel held_scalar[] = {
      prefilter_kernel<0, false>, prefilter_kernel<1, false>, prefilter_kernel<2, false>,
      prefilter_kernel<3, false>, prefilter_kernel<4, false>};
  const int nv = (d + 127) / 128;
  const int i = nv <= kMaxHeld ? nv : 0;
  return vec ? held_vec[i] : held_scalar[i];
}

}  // namespace

// basis [n, d] raw. rows (a block's warps), blocks and smem (n * d floats)
// are the wrapper's plan.
extern "C" int prefilter_launch(const float* x, int B, int d, const float* basis, int n,
                                float* r, int rows, int blocks, long long smem,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0;
  const PrefilterKernel kernel = prefilter_for(d, vec);
  cudaError_t err = allow_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, 32 * rows, (size_t)smem, st>>>(x, B, d, basis, n, r);
  return (int)cudaGetLastError();
}
