// Nearest centroid over pre-normalized rows, shared by the admit and
// assign kernels: one register-blocked cosine tile kernel that also does
// the merge.
//
// Each block takes a tile of 64 rows x 64 centroids (264 blocks at B =
// 256, K = 4218: two to an SM). Its 128 threads each hold an 8 x 4 block
// of dots in registers. The tile's rows and centroids are staged in slabs
// of 32 components, row-major in shared memory, by cp.async (16 bytes,
// straight from device memory, zero-filled past B, K or d) three slabs
// deep, so two slabs' loads are in flight while one is computed; that
// took 4% off staging one slab ahead through registers. (Neither is bound
// by its FMAs: a variant without them took 80% of the time; PERF.md.)
// A thread reads 4 components of each of its rows and centroids with one
// 16-byte load each (12 loads feed 128 FMAs); its centroids are tc + 16j,
// so a warp's 16 centroid reads fall on distinct banks. Every dot is one
// fp32 accumulation over d in order (no split over d), so sims do not
// change from run to run. Rows of d % 4 != 0 (or unaligned) are staged
// with 4-byte loads instead, one slab at a time.
//
// Merge: each row's (max, lowest index) over the tile goes into a 64-bit
// atomicMax on the composite key of keys.cuh (ordered score bits, then
// 0xFFFFFFFF - centroid), so the result does not depend on the order the
// tiles finish in; the last block to finish (a counter after a fence)
// decodes the keys into (label, exact fp32 max). The keys and the counter
// are zeroed by the unit-row launch before this one (init_assign_keys).
// With PDL (admit's instantiation) the tile kernel is a programmatic
// dependent launch: its blocks may start while that unit-row launch still
// runs, and they wait for it (griddepcontrol.wait) before their first read
// of the unit rows and before any write; PDL = false (assign's) compiles to
// the kernel without the wait.
// Ties go to the lowest centroid index everywhere: a thread keeps its first
// strict maximum over its columns in ascending order, the shuffle compares
// (value, index) with `better`, and the key orders equal scores by index.
// Columns past K are never candidates.
#pragma once

#include "keys.cuh"

namespace {

constexpr int kTileRows = 64;   // rows per assign tile
constexpr int kTileCols = 64;   // centroids per assign tile
constexpr int kSlab = 32;       // components staged per step
constexpr int kStages = 3;      // slabs in shared memory at once
constexpr int kLd = kSlab + 4;  // row stride of a slab in floats (16-byte aligned)
constexpr int kTileThreads = 128;  // 8 x 16 threads, an 8 x 4 block each
constexpr size_t kTileSmem = (size_t)kStages * (kTileRows + kTileCols) * kLd * sizeof(float);

// Zeroes the B keys and the done counter; called by every thread of the
// launch before the tile kernel (gid, nthreads: its global id and count).
__device__ __forceinline__ void init_assign_keys(key64* keys, unsigned* done, int B,
                                                 long long gid, long long nthreads) {
  for (long long b = gid; b < B; b += nthreads) keys[b] = 0;
  if (gid == 0) *done = 0;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 16 : 0));
}

template <bool VEC, bool PDL>
__global__ void __launch_bounds__(kTileThreads)
    assign_tile_kernel(const float* __restrict__ xn, int B, int d,
                       const float* __restrict__ cn, int K, key64* __restrict__ keys,
                       unsigned* __restrict__ done, int* __restrict__ label,
                       float* __restrict__ sim) {
  extern __shared__ __align__(16) float tile_smem[];
  float* xs = tile_smem;                              // [kStages][kTileRows][kLd]
  float* cs = tile_smem + kStages * kTileRows * kLd;  // [kStages][kTileCols][kLd]
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;  // rows tr*8 .. +8, centroids tc + 16j
  const int row0 = blockIdx.y * kTileRows, col0 = blockIdx.x * kTileCols;
  const int steps = (d + kSlab - 1) / kSlab;

  // slab s (components [s * kSlab, +kSlab)) of the tile's rows and
  // centroids into stage buffer b
  auto issue = [&](int s, int b) {
    if (s >= steps) return;
    const int k0 = s * kSlab;
    float* xb = xs + b * kTileRows * kLd;
    float* cb = cs + b * kTileCols * kLd;
    if (VEC) {
      constexpr int kChunks = kSlab / 4;  // 16-byte chunks to a slab row
      for (int e = tid; e < kTileRows * kChunks; e += kTileThreads) {
        const int r = e / kChunks, c = k0 + (e % kChunks) * 4;
        const bool ok = row0 + r < B && c < d;
        cp_async16(xb + r * kLd + (e % kChunks) * 4,
                   ok ? xn + (size_t)(row0 + r) * d + c : xn, ok);
      }
      for (int e = tid; e < kTileCols * kChunks; e += kTileThreads) {
        const int r = e / kChunks, c = k0 + (e % kChunks) * 4;
        const bool ok = col0 + r < K && c < d;
        cp_async16(cb + r * kLd + (e % kChunks) * 4,
                   ok ? cn + (size_t)(col0 + r) * d + c : cn, ok);
      }
    } else {
      for (int e = tid; e < kTileRows * kSlab; e += kTileThreads) {
        const int r = e / kSlab, c = k0 + e % kSlab;
        xb[r * kLd + e % kSlab] =
            (row0 + r < B && c < d) ? xn[(size_t)(row0 + r) * d + c] : 0.f;
      }
      for (int e = tid; e < kTileCols * kSlab; e += kTileThreads) {
        const int r = e / kSlab, c = k0 + e % kSlab;
        cb[r * kLd + e % kSlab] =
            (col0 + r < K && c < d) ? cn[(size_t)(col0 + r) * d + c] : 0.f;
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // the unit rows and the zeroed keys are the previous launch's writes
  if constexpr (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int s = 0; s < steps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));  // slab s landed
    __syncthreads();  // ... for every thread, and no one still reads slab s - 1
    issue(s + kStages - 1, (s + kStages - 1) % kStages);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* xb = xs + (s % kStages) * kTileRows * kLd + tr * 8 * kLd;
    const float* cb = cs + (s % kStages) * kTileCols * kLd + tc * kLd;
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 4) {
      float4 a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *(const float4*)(xb + i * kLd + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *(const float4*)(cb + 16 * j * kLd + kk);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // components in order: one sum over d
          float t = fmaf(a[i].x, b[j].x, acc[i][j]);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          acc[i][j] = fmaf(a[i].w, b[j].w, t);
        }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // per row: (max, lowest centroid) over this thread's 4 columns, then over
  // the 16 threads (16 consecutive lanes) that share the row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // ascending centroids
      const int c = col0 + tc + 16 * j;
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
    const int row = row0 + tr * 8 + i;
    if (tc == 0 && row < B && bi != INT_MAX)
      atomicMax(&keys[row], make_key(ordered_bits(bv), (unsigned)bi));
  }

  // the last block to finish decodes every row's key
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int b = tid; b < B; b += blockDim.x) {
    const key64 key = *(volatile key64*)&keys[b];
    label[b] = key_row(key);
    sim[b] = key_score(key);
  }
}

// Launches the tile kernel on unit rows xn [B, d] and unit centroids
// cn [K, d]; keys [B] and done must have been zeroed (init_assign_keys)
// earlier on the same stream. PDL: as a programmatic dependent launch of
// the kernel just before it on the stream (the unit-row launch).
template <bool PDL = false>
static cudaError_t launch_assign_tiles(const float* xn, int B, int d, const float* cn,
                                       int K, key64* keys, unsigned* done, int* label,
                                       float* sim, cudaStream_t st) {
  const bool vec = d % 4 == 0 && (uintptr_t)xn % 16 == 0 && (uintptr_t)cn % 16 == 0;
  auto kernel = vec ? assign_tile_kernel<true, PDL> : assign_tile_kernel<false, PDL>;
  cudaError_t err = allow_smem(kernel, kTileSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((K + kTileCols - 1) / kTileCols, (B + kTileRows - 1) / kTileRows);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = kTileSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = PDL ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, xn, B, d, cn, K, keys, done, label, sim);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
