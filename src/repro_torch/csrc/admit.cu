// Fused ingest admission for one microbatch (paper Algorithm 1, steps 1-3).
//
// Replaces: src/repro/kernels/admit/admit.py::admit_pallas (_admit_kernel).
//
// Per row of x [B, d] it emits the prefilter score r (mean cosine against
// the unit basis rows), keep = (r >= alpha) & live, the nearest centroid
// (label, cosine) with ties to the lowest index, and the ring-write-ready
// row: unit (or raw) fp32, or symmetric int8 plus a per-row fp32 scale.
// Every normalization, of the rows, the basis and the centroids, is the
// reference's exact sequence v / max(sqrt(sum v^2), 1e-12): IEEE divide and
// sqrt (this library is built without --use_fast_math), so int8 rows and
// scales follow the plain version. The basis comes raw: the kernel
// normalizes it, as the TPU kernel's wrapper does before its kernel.
//
// Bound on this card: the centroid scan is 2*B*K*d fp32 operations against
// B*d + K*d words read, so at B=256 it is bound by fp32 operations, not
// bytes (about 0.83 GFLOP, 12 us at 67 TFLOP/s). Design: two launches on
// the caller's stream and no other device work.
// (1) admit_prologue_kernel, one warp per row and per centroid, 8 warps a
// block over B + K warps. Each warp first issues the loads of its row or
// centroid, held in registers (16-byte loads where d % 4 == 0 and the rows
// are aligned, 4-byte loads otherwise; rows longer than 512 floats are
// read again on each pass instead). The blocks that hold row warps
// normalize the n basis rows into their shared memory meanwhile (the
// other blocks skip that). Every warp writes its unit row or centroid to a
// scratch buffer for the scan; then, past one barrier, a row warp does the
// rest of the row-only work with warp shuffles: the screen (n warp dots
// against the shared basis, the mean over the true n), keep, and the int8
// or fp32 row and its scale. A zero row (a ragged batch's padding) skips
// its divisions, which would give it the same bits on their slow path.
// Every thread zeroes its share of the merge keys.
// (2) assign_tiles.cuh's register-blocked tile kernel (shared with the
// assign kernel, in its own PDL instantiation) computes the cosines of 64
// rows x 64 centroids per block (an 8 x 4 block per thread, 264 blocks at
// B=256, K=4218), folds each row's (max, lowest index) per tile into a
// 64-bit atomicMax key, and its last block decodes the keys into labels
// and sims. It is a programmatic dependent launch: its blocks may start as
// the prologue's blocks finish (each one's exit is its trigger), so its
// launch overlaps the prologue's tail, and it waits for the prologue's
// writes (griddepcontrol.wait) before it reads a unit row or touches a
// key. The prologue sets no earlier trigger: tile blocks made resident at
// its start, beside its blocks, made the scan slower (PERF.md, admit).
// No tensor cores yet: wgmma in fp32 has no full-precision path, and the
// keep/label contract is with full-fp32 sums.
#include "assign_tiles.cuh"

namespace {

constexpr int kPrologueWarps = 8;  // rows or centroids a prologue block takes
constexpr int kMaxHeld = 4;        // chunks of 4 floats a lane holds (d <= 512)

// int8 row: rint(v / scale) clamped to [-127, 127], as the plain version's
// quantize_int8
__device__ __forceinline__ signed char quantize(float v, float scale) {
  return (signed char)fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
}

template <int NV, bool VEC>
__global__ void __launch_bounds__(kPrologueWarps * 32)
    admit_prologue_kernel(const float* __restrict__ x, int B, int d,
                          const float* __restrict__ basis, int n,
                          const float* __restrict__ c, int K,
                          const unsigned char* __restrict__ live, float alpha,
                          int emit_rows, int quantized, int normalize,
                          float* __restrict__ r_out, unsigned char* __restrict__ keep_out,
                          void* __restrict__ row_out, float* __restrict__ scale_out,
                          float* __restrict__ xn, float* __restrict__ cn,
                          key64* __restrict__ keys, unsigned* __restrict__ done) {
  extern __shared__ __align__(16) float svn[];  // [n][d] unit basis rows
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  init_assign_keys(keys, done, B, gid, (long long)gridDim.x * blockDim.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kPrologueWarps + warp;
  // the warp's row or centroid (a warp past B + K rereads the last
  // centroid and stops): its loads are in flight while the basis is
  // normalized
  const float* src = w < B ? x + (size_t)w * d : c + (size_t)(min(w, B + K - 1) - B) * d;
  WarpRow<NV, VEC> row(src, d, lane);

  if (blockIdx.x * kPrologueWarps < B) {  // block-uniform: a block with row warps
    for (int i = warp; i < n; i += kPrologueWarps) {
      const float* vi = basis + (size_t)i * d;
      float ss = 0.f;
      for (int t = lane; t < d; t += 32) ss += vi[t] * vi[t];
      const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
      for (int t = lane; t < d; t += 32) svn[(size_t)i * d + t] = vi[t] / nrm;
    }
  }
  // the unit row or centroid (needs no basis). A zero row (a ragged
  // batch's padding) keeps its +-0s: dividing them by the 1e-12 floor
  // gives the same bits on the division's slow path.
  const float nrm = fmaxf(sqrtf(warp_sum(row.sumsq())), 1e-12f);
  if (!row.all_zero()) row.divide(nrm);
  if (w < B + K) {
    float* dst = w < B ? xn + (size_t)w * d : cn + (size_t)(w - B) * d;
    row.each([&](int ch, const float(&v)[4]) { store_chunk<VEC>(dst, d, lane, ch, v); });
  }
  if (blockIdx.x * kPrologueWarps >= B) return;  // block-uniform: no row warps
  __syncthreads();  // the unit basis is in shared memory
  if (w >= B) return;  // warp-uniform; no barrier follows

  const int b = w;
  // the screen: mean over the n basis rows of cos(x, v_i) (times 1: the
  // unit row as it is)
  const float r = screen_sum(row, svn, n, d, lane, 1.f) / (float)n;
  if (lane == 0) {
    r_out[b] = r;
    keep_out[b] = (r >= alpha && (live == nullptr || live[b] != 0)) ? 1 : 0;
  }
  if (!emit_rows) return;

  auto emit = [&](WarpRow<NV, VEC>& v) {
    if (quantized) {
      float amax = 0.f;
      v.each([&](int, const float(&u)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(u[e]));
      });
      amax = warp_max(amax);
      const float scale = fmaxf(amax, 1e-12f) / 127.0f;
      signed char* q = (signed char*)row_out + (size_t)b * d;
      v.each([&](int ch, const float(&u)[4]) {
        signed char c[4] = {0, 0, 0, 0};  // a zero row's, without its divisions
        if (amax != 0.f) {
#pragma unroll
          for (int e = 0; e < 4; ++e) c[e] = quantize(u[e], scale);
        }
        if (VEC) {
          const int p = chunk_pos<true>(lane, ch, 0);
          if (p < d) *(char4*)(q + p) = make_char4(c[0], c[1], c[2], c[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = chunk_pos<false>(lane, ch, e);
            if (p < d) q[p] = c[e];
          }
        }
      });
      if (lane == 0) scale_out[b] = scale;
    } else {
      float* o = (float*)row_out + (size_t)b * d;
      v.each([&](int ch, const float(&u)[4]) { store_chunk<VEC>(o, d, lane, ch, u); });
      if (lane == 0) scale_out[b] = 1.0f;
    }
  };
  if (normalize) {
    emit(row);
  } else {
    WarpRow<NV, VEC> raw(x + (size_t)b * d, d, lane);  // read again (L1)
    emit(raw);
  }
}

using PrologueKernel = decltype(&admit_prologue_kernel<1, true>);

// The instantiation for rows of d floats: NV = ceil(d / 128) chunks a lane
// held in registers, or 0 (reread) past kMaxHeld.
PrologueKernel prologue_for(int d, bool vec) {
  static const PrologueKernel held_vec[] = {
      admit_prologue_kernel<0, true>, admit_prologue_kernel<1, true>,
      admit_prologue_kernel<2, true>, admit_prologue_kernel<3, true>,
      admit_prologue_kernel<4, true>};
  static const PrologueKernel held_scalar[] = {
      admit_prologue_kernel<0, false>, admit_prologue_kernel<1, false>,
      admit_prologue_kernel<2, false>, admit_prologue_kernel<3, false>,
      admit_prologue_kernel<4, false>};
  const int nv = (d + 127) / 128;
  const int i = nv <= kMaxHeld ? nv : 0;
  return vec ? held_vec[i] : held_scalar[i];
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// scratch: xn [B, d] f32, cn [K, d] f32 (16-byte aligned) and keys (B merge
// keys, then the done counter); live may be null (every row live); row and
// scale are null when emit_rows is 0. blocks and smem are the wrapper's
// plan (kernels/admit/admit.py::admit_plan): ceil((B + K) / 8) blocks and
// n * d floats of shared memory. phases: 1 = the prologue, 2 = the tile
// kernel, 3 = both (the call; a timing script may launch them apart).
extern "C" int admit_launch(const float* x, int B, int d, const float* basis, int n,
                            const float* centroids, int K,
                            const unsigned char* live, float alpha, int emit_rows,
                            int quantized, int normalize, float* r,
                            unsigned char* keep, int* label, float* sim, void* row,
                            float* scale, float* xn_scratch, float* cn_scratch,
                            void* keys, int blocks, long long smem, int phases,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  key64* k64 = (key64*)keys;
  unsigned* done = (unsigned*)(k64 + B);
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(centroids) &&
                   aligned16(xn_scratch) && aligned16(cn_scratch) &&
                   (!emit_rows || (uintptr_t)row % (quantized ? 4 : 16) == 0);
  cudaError_t err = cudaSuccess;
  if (phases & 1) {
    const PrologueKernel prologue = prologue_for(d, vec);
    if ((err = allow_smem(prologue, (size_t)smem)) != cudaSuccess) return (int)err;
    prologue<<<blocks, kPrologueWarps * 32, (size_t)smem, st>>>(
        x, B, d, basis, n, centroids, K, live, alpha, emit_rows, quantized, normalize, r,
        keep, row, scale, xn_scratch, cn_scratch, k64, done);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phases & 2)
    err = launch_assign_tiles<true>(xn_scratch, B, d, cn_scratch, K, k64, done, label, sim,
                                    st);
  return (int)err;
}
