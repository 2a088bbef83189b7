// The whole two-stage query: route -> gather -> dequant-rerank -> top-k.
//
// Replaces: src/repro/kernels/serve/serve.py::serve_topk_pallas (_serve_kernel).
//
// Two launches where a query's route keys fit one block's shared memory,
// more past that (1b).
// (1) route_tile_kernel: the route scores qr . vectors^T as register-blocked
// fp32 tiles of 8 * RM queries x 64 prototypes, built the way
// assign_tiles.cuh builds assign's tiles (route_dots below). The epilogue
// keeps each (query, column tile)'s top-nprobe as keys.cuh's composite keys
// (ordered score bits, then 0xFFFFFFFF - slot; invalid slots score
// NEG_INF, columns past cap give no key) by nprobe rounds of a 16-lane max
// below the last pick, so ties across tiles stay exact; the [Q, cap] score
// matrix never reaches device memory, only [Q, tiles * min(nprobe, 64)]
// keys do (a thread's RM rows take their rounds side by side, so their
// shuffles overlap). RM (8, 4 or 2) is the wrapper's pick
// (kernels/serve/serve.py::serve_plan) so that the grid covers the 132 SMs:
// at Q = 64, cap 4218 that is RM = 4, 66 x 2 blocks.
// (2) serve_rerank_kernel, Q clusters of CS blocks (rings.cuh): every block
// of a query's cluster takes the top-nprobe of its route keys (warp max
// rounds, then a rank), maps the slots through route_labels (a dead slot or
// score gives route -1), then scores its share of the routed rings' slots
// (16-byte loads, a lane group a row, the query in registers; a
// depth-clipped view embs[:, :depth] is read in place, never copied) and
// the leader merges the blocks' top-k keys from distributed shared memory;
// pos = j * depth + slot, -1 where dead. A slot is live where its document
// id (the ring ids view, read through its strides) is >= 0. The scoring and
// the top-k are rings.cuh's, shared with the rerank kernel. The leader's
// epilogue decodes each pick while the routes are in its shared memory:
// cluster = sroutes[j], doc_id = ids[cluster, slot], row = cluster *
// store_depth + slot (store_depth the full ring depth, whatever view is
// served), -1 where dead; so the call returns the answer, and no torch op
// runs after it. The second launch is a programmatic dependent launch: the
// route tiles let it start at their epilogue, and it reads the queries and
// their keys only after griddepcontrol.wait.
//
// (1b) route_merge_kernel, only where a query has more route keys than its
// selection ranks (past 16,384, or past what fits one block's shared
// memory beside the ring layout; from cap 65,537 at nprobe 16, 131,073 at
// nprobe 8): a route tile's kt keys are in descending order, so one warp
// a (query, group of 32 tiles) merges the group's 32 lists (a lane a
// list, its next 4 keys in registers; each round's largest head by two
// warp reductions, the score word then the row word) into the group's
// top-nprobe, in descending order, 0 past its keys: [Q, m] becomes [Q,
// ceil(tiles / 32) * nprobe] in device memory, and the pass repeats over
// those lists until they are few enough. It is exact: the keys are unique, so the top-nprobe of the union lies in the union
// of the groups' top-nprobe, and the selection ranks the same keys. The
// sizes are the wrapper's (serve_plan's levels, one rule for both
// entries); shapes with fewer keys launch none of it.
//
// The route-only entry (serve_route_launch) is stage 1 alone, the serving
// cache's route witness: the same route tiles and merge passes, then
// route_select_kernel, one block a query,
// which takes the top-nprobe of the query's route keys
// with the same block_topk_keys and maps them through route_labels as
// serve_rerank_kernel does before its rerank. So its routes are the fused
// kernel's, in the fused kernel's order, bit for bit: one computation, not
// two summations of the same dots.
//
// Bound on this card: bytes. A call must read the queries, the index
// (6.5 MB at cap 4218) and the distinct routed rings (depth * d bytes each
// for int8: up to 12.6 MB when 64 queries' 8 routes at depth 64, d 384 are
// all distinct); its arithmetic, 2 * Q * (cap + nprobe * depth) * d fp32
// operations (0.23 GFLOP), takes less time: 0.0037 ms for chip_smoke.py's
// inputs. On an H100 80GB HBM3 at 700 W the call takes about 0.030 ms, 8x
// that bound: route tiles 0.015 ms (about a fifth of the FMA peak: one
// block of 4 warps an SM), rerank 0.015 ms (tools/kernel_ab.py; PERF.md).
#include "rings.cuh"

namespace {

constexpr int kTileCols = 64;      // prototypes per route tile
constexpr int kTileThreads = 128;  // 8 x 16 threads, an RM x 4 block of dots each
constexpr int kStages = 3;         // slabs in shared memory at once
constexpr int kSlab = 64;          // components staged per step
constexpr int kLd = kSlab + 4;     // row stride of a slab in floats (16-byte aligned)

// Dynamic shared memory of a route tile of 8 * RM queries.
constexpr size_t tile_smem_bytes(int RM) {
  return (size_t)kStages * (8 * RM + kTileCols) * kLd * sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 16 : 0));
}

// acc[i][j] = q[row0 + tr * RM + i] . v[col0 + tc + 16 j] (tr = tid >> 4,
// tc = tid & 15; zero past Q or cap). The tile's queries and prototypes are
// staged in slabs of 64 components, row-major in shared memory, by cp.async
// (16 bytes, straight from device memory, zero-filled past Q, cap or d)
// three slabs deep, so two slabs' loads are in flight while one is
// computed. A thread reads 4 components of each of its rows and columns
// with one 16-byte load each (RM + 4 loads feed 16 RM FMAs); its columns
// are tc + 16 j, so a warp's 16 column reads fall on distinct banks. Every
// dot is one fp32 accumulation over d in order (no split over d), so route
// scores do not change from run to run. Rows of d % 4 != 0 (or unaligned)
// are staged with 4-byte loads instead (VEC false), one slab at a time.
template <int RM, bool VEC>
__device__ __forceinline__ void route_dots(const float* __restrict__ q, int Q, int d,
                                           const float* __restrict__ v, int cap, int row0,
                                           int col0, float* smem, float (&acc)[RM][4]) {
  constexpr int TR = 8 * RM;  // rows of the tile
  float* qs = smem;                       // [kStages][TR][kLd]
  float* vs = smem + kStages * TR * kLd;  // [kStages][kTileCols][kLd]
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int steps = (d + kSlab - 1) / kSlab;

  // slab s (components [s * kSlab, +kSlab)) of the tile's rows and
  // columns into stage buffer b
  auto issue = [&](int s, int b) {
    if (s >= steps) return;
    const int k0 = s * kSlab;
    float* qb = qs + b * TR * kLd;
    float* vb = vs + b * kTileCols * kLd;
    if (VEC) {
      constexpr int kChunks = kSlab / 4;  // 16-byte chunks to a slab row
      for (int e = tid; e < TR * kChunks; e += kTileThreads) {
        const int r = e / kChunks, k = k0 + (e % kChunks) * 4;
        const bool ok = row0 + r < Q && k < d;
        cp_async16(qb + r * kLd + (e % kChunks) * 4,
                   ok ? q + (size_t)(row0 + r) * d + k : q, ok);
      }
      for (int e = tid; e < kTileCols * kChunks; e += kTileThreads) {
        const int r = e / kChunks, k = k0 + (e % kChunks) * 4;
        const bool ok = col0 + r < cap && k < d;
        cp_async16(vb + r * kLd + (e % kChunks) * 4,
                   ok ? v + (size_t)(col0 + r) * d + k : v, ok);
      }
    } else {
      for (int e = tid; e < TR * kSlab; e += kTileThreads) {
        const int r = e / kSlab, k = k0 + e % kSlab;
        qb[r * kLd + e % kSlab] = (row0 + r < Q && k < d) ? q[(size_t)(row0 + r) * d + k] : 0.f;
      }
      for (int e = tid; e < kTileCols * kSlab; e += kTileThreads) {
        const int r = e / kSlab, k = k0 + e % kSlab;
        vb[r * kLd + e % kSlab] =
            (col0 + r < cap && k < d) ? v[(size_t)(col0 + r) * d + k] : 0.f;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

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
    const float* qb = qs + (s % kStages) * TR * kLd + tr * RM * kLd;
    const float* vb = vs + (s % kStages) * kTileCols * kLd + tc * kLd;
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 4) {
      float4 a[RM], b[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = *(const float4*)(qb + i * kLd + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *(const float4*)(vb + 16 * j * kLd + kk);
#pragma unroll
      for (int i = 0; i < RM; ++i)
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
}

// part [Q, gridDim.x * kt]: each (query, 64-column tile)'s kt largest keys,
// in order, 0 past the tile's columns.
template <int RM, bool VEC>
__global__ void __launch_bounds__(kTileThreads)
    route_tile_kernel(const float* __restrict__ qr, int Q, int d,
                      const float* __restrict__ vectors, int cap,
                      const unsigned char* __restrict__ valid, int kt,
                      key64* __restrict__ part) {
  extern __shared__ __align__(16) float tile_smem[];
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int row0 = blockIdx.y * 8 * RM, col0 = blockIdx.x * kTileCols;
  float acc[RM][4];
  route_dots<RM, VEC>(qr, Q, d, vectors, cap, row0, col0, tile_smem, acc);
  // the rerank launch may start now: its blocks set up beside this epilogue
  asm volatile("griddepcontrol.launch_dependents;\n");
  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + tc + 16 * j;
    ok[j] = c < cap && valid[c];
  }
  key64 key[RM][4], last[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    last[i] = ~0ull;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tc + 16 * j;
      key[i][j] = c < cap ? make_key(ordered_bits(ok[j] ? acc[i][j] : REPRO_NEG_INF), (unsigned)c)
                          : 0ull;
    }
  }
  // the 16 lanes of a row pick its next key each round, the thread's RM rows
  // side by side so their shuffles overlap
  key64* out = part + ((size_t)(row0 + tr * RM) * gridDim.x + blockIdx.x) * kt;
  for (int r = 0; r < kt; ++r) {
    key64 m[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      m[i] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (key[i][j] < last[i] && key[i][j] > m[i]) m[i] = key[i][j];
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < RM; ++i) m[i] = max(m[i], __shfl_xor_sync(REPRO_FULL_MASK, m[i], o));
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      last[i] = m[i];
      if (tc == 0 && row0 + tr * RM + i < Q) out[(size_t)i * gridDim.x * kt + r] = m[i];
    }
  }
}

template <int RM>
cudaError_t launch_route_tiles(const float* qr, int Q, int d, const float* vectors, int cap,
                               const unsigned char* valid, int kt, key64* part,
                               cudaStream_t st) {
  const dim3 grid((cap + kTileCols - 1) / kTileCols, (Q + 8 * RM - 1) / (8 * RM));
  const size_t smem = tile_smem_bytes(RM);
  cudaError_t err;
  if (d % 4 == 0 && (uintptr_t)qr % 16 == 0 && (uintptr_t)vectors % 16 == 0) {
    if ((err = allow_smem(route_tile_kernel<RM, true>, smem)) != cudaSuccess) return err;
    route_tile_kernel<RM, true><<<grid, kTileThreads, smem, st>>>(qr, Q, d, vectors, cap,
                                                                  valid, kt, part);
  } else {
    if ((err = allow_smem(route_tile_kernel<RM, false>, smem)) != cudaSuccess) return err;
    route_tile_kernel<RM, false><<<grid, kTileThreads, smem, st>>>(qr, Q, d, vectors, cap,
                                                                   valid, kt, part);
  }
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kRingThreads)
    serve_rerank_kernel(const float* __restrict__ qn, int d, int G,
                        const key64* __restrict__ part, int m,
                        const int* __restrict__ route_labels, RingView rv, int store_depth,
                        int k, int nprobe, float* __restrict__ out_scores,
                        int* __restrict__ out_pos, int* __restrict__ out_routes,
                        int* __restrict__ out_rows, int* __restrict__ out_doc_ids,
                        int* __restrict__ out_clusters) {
  extern __shared__ __align__(16) unsigned char ring_smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const bool leader = cluster.block_rank() == 0;
  const int qi = blockIdx.x / cs;
  const RingSmem L = ring_smem(d, nprobe, rv.depth, k, cs, m);
  ring_cluster_start(ring_smem_raw, L, nprobe, rv.depth, k);
  float* sq = (float*)(ring_smem_raw + L.sq);
  int* sroutes = (int*)(ring_smem_raw + L.sroutes);
  key64* rk = (key64*)(ring_smem_raw + L.rk);
  // part is the route tiles'; qn too may come from the kernel just before
  // (phase 2 launched alone, behind whatever wrote qn)
  wait_for_previous_kernel();
  for (int t = threadIdx.x; t < d; t += blockDim.x) sq[t] = qn[(size_t)qi * d + t];
  for (int c = threadIdx.x; c < m; c += blockDim.x) rk[c] = part[(size_t)qi * m + c];
  __syncthreads();

  // ---- top-nprobe slots -> clusters
  int* orow = out_routes + (size_t)qi * nprobe;
  block_topk_keys(rk, m, nprobe, (key64*)(ring_smem_raw + L.rlst), [&](int p, key64 key) {
    const int lbl = route_labels[key_row(key)];
    const int route = (key_score(key) > REPRO_NEG_INF / 2 && lbl >= 0) ? lbl : -1;
    sroutes[p] = route;
    if (leader) orow[p] = route;
  });

  // ---- gather + score the routed rings, then the top-k, decoded
  const size_t o = (size_t)qi * k;
  ring_topk(ring_smem_raw, L, sq, d, G, sroutes, nprobe, rv, k, [&](int t, key64 key) {
    const int p = pick_pos(key);
    int cl = -1, doc = -1, row = -1;
    if (p >= 0) {  // a live pick's route is live
      const int j = p / rv.depth, slot = p - j * rv.depth;
      cl = sroutes[j];
      doc = rv.ids[cl * rv.is0 + slot * rv.is1];
      row = (int)((long long)cl * store_depth + slot);
    }
    out_scores[o + t] = key_score(key);
    out_pos[o + t] = p;
    out_rows[o + t] = row;
    out_doc_ids[o + t] = doc;
    out_clusters[o + t] = cl;
  });
}

// out_routes [Q, nprobe]: the top-nprobe of each query's route keys (part
// [Q, m], as the route tiles or the last merge pass left them) mapped
// through route_labels, -1
// where the slot's score or label is dead; serve_rerank_kernel's first step.
__global__ void __launch_bounds__(kRingThreads)
    route_select_kernel(const key64* __restrict__ part, int m,
                        const int* __restrict__ route_labels, int nprobe,
                        int* __restrict__ out_routes) {
  extern __shared__ __align__(16) unsigned char sel_smem[];
  key64* rk = (key64*)sel_smem;  // [m]
  key64* rlst = rk + m;          // [kRingWarps * warp_keep(m, nprobe)]
  const int qi = blockIdx.x;
  wait_for_previous_kernel();  // part is the route tiles'
  for (int c = threadIdx.x; c < m; c += blockDim.x) rk[c] = part[(size_t)qi * m + c];
  __syncthreads();
  int* orow = out_routes + (size_t)qi * nprobe;
  block_topk_keys(rk, m, nprobe, rlst, [&](int p, key64 key) {
    const int lbl = route_labels[key_row(key)];
    orow[p] = (key_score(key) > REPRO_NEG_INF / 2 && lbl >= 0) ? lbl : -1;
  });
}

size_t route_select_smem(int m, int nprobe) {
  return (size_t)(m + kRingWarps * warp_keep(m, nprobe)) * 8;
}

constexpr int kMergeWays = 32;  // sorted key lists a warp of a pass merges, a lane each
constexpr int kMergeAhead = 4;  // keys of its list a lane holds in registers

// out [Q, ngroups * nprobe]: for each group of kMergeWays consecutive lists
// of len keys of a query's in [Q, nlists * len] (each in descending order,
// 0 past its keys), the group's nprobe largest keys in descending order, 0
// past them. One warp a (query, group), lane l walking list l.
__global__ void __launch_bounds__(kRingThreads)
    route_merge_kernel(const key64* __restrict__ in, int Q, int nlists, int len,
                       int ngroups, int nprobe, key64* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kRingWarps + (threadIdx.x >> 5);
  wait_for_previous_kernel();  // in is the route tiles' (or the pass before's)
  if (w >= (long long)Q * ngroups) return;  // warp-uniform
  const int qi = (int)(w / ngroups), gi = (int)(w - (long long)qi * ngroups);
  const int list = gi * kMergeWays + lane;
  const bool ok = list < nlists;
  const key64* src = in + ((size_t)qi * nlists + (ok ? list : 0)) * len;
  key64 q[kMergeAhead];
#pragma unroll
  for (int j = 0; j < kMergeAhead; ++j) q[j] = ok && j < len ? src[j] : 0ull;
  int next = kMergeAhead;
  key64* orow = out + (size_t)w * nprobe;
  for (int r = 0; r < nprobe; ++r) {
    const unsigned hi = (unsigned)(q[0] >> 32), lo = (unsigned)q[0];
    const unsigned mh = __reduce_max_sync(REPRO_FULL_MASK, hi);
    const unsigned ml = __reduce_max_sync(REPRO_FULL_MASK, hi == mh ? lo : 0u);
    const key64 m = ((key64)mh << 32) | ml;  // 0 once every list is spent
    if (lane == 0) orow[r] = m;
    if (m != 0ull && q[0] == m) {  // this lane's head: the keys are unique
#pragma unroll
      for (int j = 0; j + 1 < kMergeAhead; ++j) q[j] = q[j + 1];
      q[kMergeAhead - 1] = ok && next < len ? src[next] : 0ull;
      ++next;
    }
  }
}

// The merge passes over part [Q, ntiles * kt] (the route tiles' lists of
// kt keys): each merges every kMergeWays lists into one list of nprobe,
// alternating between part2 and part, until a query has msel keys. *sel
// gets the array the selection reads (part itself where there is no
// pass); with launch false nothing is launched (a caller that timed the
// passes apart). Refuses a plan whose levels do not end at msel.
cudaError_t merge_keys(int Q, int ntiles, int kt, int msel, int nprobe, key64* part,
                       key64* part2, bool launch, const key64** sel, cudaStream_t st) {
  key64* bufs[2] = {part2, part};
  const key64* src = part;
  int nlists = ntiles, len = kt;
  for (int lv = 0; nlists * len > msel; ++lv) {
    const int ng = (nlists + kMergeWays - 1) / kMergeWays;
    if ((long long)ng * nprobe >= (long long)nlists * len || !part2)
      return cudaErrorInvalidValue;
    key64* dst = bufs[lv & 1];
    if (launch) {
      const long long warps = (long long)Q * ng;
      const cudaError_t err = launch_ring(route_merge_kernel,
                                          (int)((warps + kRingWarps - 1) / kRingWarps), 1, 0,
                                          st, src, Q, nlists, len, ng, nprobe, dst);
      if (err != cudaSuccess) return err;
    }
    src = dst;
    nlists = ng;
    len = nprobe;
  }
  if (nlists * len != msel) return cudaErrorInvalidValue;
  *sel = src;
  return cudaSuccess;
}

cudaError_t route_tiles(int rm, const float* qr, int Q, int d, const float* vectors, int cap,
                        const unsigned char* valid, int kt, key64* part, cudaStream_t st) {
  switch (rm) {
    case 8: return launch_route_tiles<8>(qr, Q, d, vectors, cap, valid, kt, part, st);
    case 4: return launch_route_tiles<4>(qr, Q, d, vectors, cap, valid, kt, part, st);
    case 2: return launch_route_tiles<2>(qr, Q, d, vectors, cap, valid, kt, part, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int serve_route_cols() { return kTileCols; }

extern "C" long long serve_route_smem_bytes(int m, int nprobe) {
  return (long long)route_select_smem(m, nprobe);
}

extern "C" int serve_merge_ways() { return kMergeWays; }

// The route-only entry: routes [Q, nprobe] exactly as serve_launch gives
// them: the route tiles, the merge passes (where msel < m), then the
// selection. rm, msel, part and part2 as for serve_launch.
extern "C" int serve_route_launch(const float* qr, int Q, int d, const float* vectors, int cap,
                                  const unsigned char* valid, const int* route_labels,
                                  int nprobe, int rm, int msel, void* part, void* part2,
                                  int* out_routes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int kt = imin(nprobe, kTileCols), ntiles = (cap + kTileCols - 1) / kTileCols;
  cudaError_t err = route_tiles(rm, qr, Q, d, vectors, cap, valid, kt, (key64*)part, st);
  if (err != cudaSuccess) return (int)err;
  const key64* sel = nullptr;
  err = merge_keys(Q, ntiles, kt, msel, nprobe, (key64*)part, (key64*)part2, true, &sel, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_ring(route_select_kernel, Q, 1, route_select_smem(msel, nprobe), st, sel, msel,
                    route_labels, nprobe, out_routes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" long long serve_smem_bytes(int d, int m, int nprobe, int depth, int k, int cs) {
  return (long long)ring_smem(d, nprobe, depth, k, cs, m).bytes;
}

// rm in {8, 4, 2} (route tile rows / 8), cs in {1, 2, 4, 8}; part [Q, m]
// keys with m = ceil(cap / 64) * min(nprobe, 64); msel the keys a query has
// after the merge passes (m where there are none), part2 [Q, the first
// pass's keys] (null without passes); ids [C, depth] (strides is0, is1);
// store_depth the depth rows are encoded with; out_scores, out_pos,
// out_rows, out_doc_ids, out_clusters [Q, k] and out_routes [Q, nprobe].
// phases: 1 = route tiles, 4 = the merge passes, 2 = rerank, 7 = all.
extern "C" int serve_launch(const float* qr, const float* qn, int Q, int d,
                            const float* vectors, int cap, const unsigned char* valid,
                            const int* route_labels, const void* embs, int depth,
                            long long es0, long long es1, const int* ids, long long is0,
                            long long is1, const float* scales, long long ss0,
                            long long ss1, int quantized, int store_depth, int k,
                            int nprobe, int rm, int cs, int msel, void* part, void* part2,
                            float* out_scores, int* out_pos, int* out_routes, int* out_rows,
                            int* out_doc_ids, int* out_clusters, int phases, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int kt = imin(nprobe, kTileCols), ntiles = (cap + kTileCols - 1) / kTileCols;
  if (cs < 1 || cs > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (phases & 1) {
    err = route_tiles(rm, qr, Q, d, vectors, cap, valid, kt, (key64*)part, st);
    if (err != cudaSuccess) return (int)err;
  }
  const key64* sel = nullptr;
  err = merge_keys(Q, ntiles, kt, msel, nprobe, (key64*)part, (key64*)part2, phases & 4, &sel,
                   st);
  if (err != cudaSuccess) return (int)err;
  if (phases & 2) {
    const RingView rv{embs, es0, es1, ids, is0, is1, scales, ss0, ss1, quantized, depth};
    const size_t smem = ring_smem(d, nprobe, depth, k, cs, msel).bytes;
    err = launch_ring(serve_rerank_kernel, Q, cs, smem, st, qn, d,
                      ring_lanes(d, quantized, embs, es0, es1), sel, msel, route_labels, rv,
                      store_depth, k, nprobe, out_scores, out_pos, out_routes, out_rows,
                      out_doc_ids, out_clusters);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
