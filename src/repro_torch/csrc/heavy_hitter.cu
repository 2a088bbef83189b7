// The streaming heavy-hitter counter's per-arrival update over one
// microbatch (paper §Streaming Heavy-Hitter Filtering; policies of paper
// Table 8, Morris counts, adaptive u_t / B_t of paper Table 9).
//
// Replaces: no Pallas kernel. The reference runs this update as one jitted
// lax.scan (src/repro/core/heavy_hitter.py::update_batch over update_one);
// the port's plain version is the same update as a Python loop of tensor
// ops (kernels/heavy_hitter/ref.py). This kernel is the scan as one launch.
//
// Semantics are update_one's, arrival by arrival, exactly: every
// decision is an integer decision or a float32 compare over the same
// floats as the plain version's (gate u <= u_t; Morris u < exp2f(-c);
// the adaptive rate novel / max(seen, 1) with an IEEE division, u_t * g
// clamped to u_max and u_t / g clamped below by u_0, the config constants
// passed as the float32 values torch casts the Python scalars to), and
// every argmin / argmax takes the lowest index on ties, as torch's do (an
// empty mask gives slot 0). int32 sums wrap as torch's do. The random
// draws are inputs: the gate uniforms [B], the Gumbel noise [B, bmax]
// (RANDOM_EVICT) and the Morris uniforms [B], so the kernel and the loop
// take the same numbers.
//
// Not in place: the kernel reads the state and writes a new one (labels,
// counts, the sketch for COUNT_MIN, the scalars) and the per-arrival info
// (admitted, hit, evicted label, slot, -1 where nothing was written).
//
// Bound on this card: bytes, and far below one launch. A batch reads the
// state (8 * bmax bytes, 33.7 KB at bmax = 4218), B labels and draws, and
// for RANDOM_EVICT the Gumbel rows of the arrivals that evict; it writes
// the state and 10 B bytes of info. What costs is latency: the fixed part
// of a launch (state in and out, the table's build, a few block
// barriers) and a chain that is serial only where one arrival's decision
// reads what an earlier one wrote.
//
// Design: one block; no arrival's step scans the slots unless its
// transition reads a minimum or a Gumbel victim, and only such a scan
// takes barriers across warps.
// - State in shared memory (dynamic, past 48 KB by the opt-in): labels,
//   counts, the sketch (COUNT_MIN), moved in and out as 16-byte vectors.
// - Membership: a label -> slot table of 16-bit slot indices, open
//   addressing with linear probing (Fibonacci hash of the label into
//   `table` entries, load factor 0.5, rising to at most 0.8 where shared
//   memory runs out); the key of an entry is the label of the slot it
//   names, so an entry costs 2 bytes. Built once per launch by every
//   thread in parallel (atomicCAS on the 32-bit word that holds the
//   entry), it maps each label to the LOWEST slot holding it anywhere. The
//   reference hits the lowest holder below B_t: that is the table's slot
//   when it is below B_t, and no holder is below B_t otherwise. An
//   insert below B_t can duplicate a label still held at or past B_t (a
//   shrink, then a grow, exposes both), so the block counts the slots
//   that are not their label's lowest holder (`dups`); when the lowest
//   holder is overwritten and dups > 0, one warp scans for the next
//   holder, else the entry is erased (backward-shift deletion).
// - Empty slots: a bitmap of bmax / 32 words and a cursor at the first
//   empty slot. No slot is emptied within a batch, so the first empty
//   slots below B_t are the cursor's and the set bits after it. The
//   occupied count below B_t is a register, raised by inserts, recounted
//   by popcount only when a window moves B_t.
// - Dropped arrivals in bulk: a chunk of 256 arrivals is staged by 256
//   threads; a dropped arrival's info (0, 0, -1, -1) is written by its own
//   thread, the valid ones are compacted in order (ballot + prefix sum).
//   A dropped arrival moves nothing but the adaptive window, which it can
//   close only once in a run (it never raises `seen`), so each run takes
//   one window step: before the next valid arrival, or at the batch's end.
// - Waves: warp 0 takes the compacted valid arrivals 32 at a time, lane j
//   arrival k0 + j, each probing the table against the state as the wave
//   starts. Arrivals that only hit, insert, or miss without a write apply
//   together, as the sequential loop would: the first arrival of a missing
//   label that may insert takes the next empty slot (ranked among the
//   wave's inserts), later arrivals of that label hit it; exact counts add
//   with shared atomics, Morris counts step in arrival order (each slot's
//   lowest lane walks its writers). A wave ends before the first arrival
//   that must go alone, after the insert that fills the counter, where the
//   empty slots below B_t run out, and at the arrival that closes the
//   adaptive window (so u_t, B_t and the room are constant within it).
// - Alone: a miss on a full counter that may evict or whose admission
//   reads the minimum (SPACE_SAVING, COUNT_MIN, MIN_EVICT and RANDOM_EVICT
//   past the gate), and an arrival whose Gumbel row is staged, take the
//   sequential step: every lane reads and decides alike, lane 0 writes,
//   between two __syncwarp. Then all slots below B_t are occupied, and the
//   (count, slot) minimum below B_t, or RANDOM_EVICT's Gumbel argmax, is
//   a block scan on demand: warp 0 posts it at a named barrier to the
//   other warps, idle while the chain runs, and all share it in two
//   passes (the extreme, then its lowest slot; three named barriers): a
//   lone warp hides neither load latency nor instruction fetch, and one
//   warp's scan of 4218 slots ran several times slower.
//   Ties as the loop's: the lowest slot with the least count; the first
//   NaN, else the lowest slot with the largest value (-0.0 == +0.0); "no
//   slot" is slot 0.
// - Gumbel rows staged ahead: in a chunk that can fill the counter, every
//   valid arrival whose uniform can pass the gate (u <= the largest u_t
//   the batch can reach) is a candidate, and lane 0 keeps two candidates'
//   rows in flight into two shared buffers with cp.async.bulk (TMA's 1-D
//   copy, the row's 16-byte aligned interior) on an mbarrier each; the
//   row's unaligned ends (at most 3 floats a side) ride 4-byte cp.async
//   copies. Where the buffers do not fit beside the table, the block
//   reads the row from device memory.
// The other warps serve the scans until warp 0's chain ends, then write
// the valid arrivals' info in parallel. The wrapper's plan
// (kernels/heavy_hitter/heavy_hitter.py::heavy_hitter_plan) sizes the
// block, the table and the staging, and refuses a bmax past shared memory.
#include "common.cuh"

namespace {

constexpr int kEmpty = -1;
constexpr int kChunk = 256;             // arrivals staged a chunk
constexpr unsigned kNoSlot = 0xffffu;   // an unused table entry
constexpr unsigned kNone = 0xffffffffu;
constexpr int kCand = 1 << 16;          // chunk flag: a Gumbel-row candidate
constexpr int kAfterDrop = 1 << 17;     // chunk flag: a dropped run ends here
enum Policy { kRandomEvict = 0, kMinEvict = 1, kSpaceSaving = 2, kCountMin = 3 };

}  // namespace

// Field order and types are mirrored by the ctypes Structures in
// kernels/heavy_hitter/heavy_hitter.py: the pointers change every call,
// the config is built once per (config, B, bmax).
struct HHPtrs {
  // arrivals and draws
  const int* labels;       // [B], < 0 for a dropped arrival
  const float* uniforms;   // [B] gate uniforms
  const float* gumbel;     // [B, bmax] (RANDOM_EVICT) or null
  const float* morris;     // [B] (Morris counts) or null
  // the state in
  const int* slot_labels;  // [bmax]
  const int* slot_counts;  // [bmax]
  const int* cms;          // [depth, width]
  const float* admit_prob;
  const int* active_capacity;
  const int* novel_in_window;
  const int* seen_in_window;
  const int* total_seen;
  const int* total_evictions;
  const int* total_writes;
  // the state out
  int* out_labels;
  int* out_counts;
  int* out_cms;            // COUNT_MIN only, else null
  float* out_admit_prob;
  int* out_active_capacity;
  int* out_novel_in_window;
  int* out_seen_in_window;
  int* out_total_seen;
  int* out_total_evictions;
  int* out_total_writes;
  // info [B]
  unsigned char* admitted;
  unsigned char* hit;
  int* evicted_label;
  int* slot;
};

struct HHConf {
  int B, bmax, policy, morris_on, gate_below_capacity, adaptive;
  int capacity, cms_depth, cms_width, window, b_step;
  float u0, novel_hi, novel_lo, u_growth, u_max;
  int table;   // entries of the label -> slot table
  int stage;   // 1: stage Gumbel rows in shared memory (RANDOM_EVICT)
};

struct HHArgs {
  HHPtrs p;
  HHConf c;
};

namespace {

// The scalar state, held in registers by every lane of warp 0 (the other
// threads read u only).
struct Scalars {
  float u;
  int cap, novel, seen, total_seen, evictions, writes;
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// The reference's uint32 Count-Min hash of a label for sketch row r.
__device__ __forceinline__ int cms_col(int label, int r, int width) {
  const unsigned seed = (unsigned)(r + 1) * 0x9E3779B1u;
  unsigned h = ((unsigned)label + seed) * 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return (int)(h % (unsigned)width);
}

// The adaptive u_t / B_t step at the end of every arrival (valid or not).
__device__ __forceinline__ void window_step(const HHConf& a, Scalars& s) {
  if (!a.adaptive) return;
  if (s.seen < a.window) return;
  const float rate = __fdiv_rn((float)s.novel, (float)max(s.seen, 1));
  const bool grow = rate > a.novel_hi, shrink = rate < a.novel_lo;
  if (grow) {
    const float g = __fmul_rn(s.u, a.u_growth);
    s.u = g > a.u_max ? a.u_max : g;
    const int c = wrap_add(s.cap, a.b_step);
    s.cap = c > a.bmax ? a.bmax : c;
  } else if (shrink) {
    const float g = __fdiv_rn(s.u, a.u_growth);
    s.u = g < a.u0 ? a.u0 : g;
    const int c = wrap_add(s.cap, -a.b_step);
    s.cap = c < a.capacity ? a.capacity : c;
  }
  s.seen = 0;
  s.novel = 0;
}

// ---- the label -> lowest-slot table (heavy_hitter.py::table_home mirrors
// the hash)
__device__ __forceinline__ unsigned table_home(int label, unsigned T) {
  return (unsigned)(((unsigned long long)((unsigned)label * 0x9E3779B1u) * T) >> 32);
}

__device__ __forceinline__ unsigned next_pos(unsigned p, unsigned T) {
  return p + 1 == T ? 0u : p + 1;
}

struct Probe {
  unsigned pos;  // the label's entry, or the empty entry that ends its chain
  int slot;      // the lowest slot holding the label, -1 if none
};

__device__ __forceinline__ Probe probe(const unsigned short* tab, const int* lab, unsigned T,
                                       int label) {
  unsigned p = table_home(label, T);
  while (true) {
    const unsigned e = tab[p];
    if (e == kNoSlot) return {p, -1};
    if (lab[e] == label) return {p, (int)e};
    p = next_pos(p, T);
  }
}

// Every thread inserts its slots in parallel: claim an empty entry, or
// lower the label's entry to this slot. Returns 1 where the label already
// had an entry (this slot or another is a duplicate holder).
__device__ __forceinline__ int table_build_insert(unsigned short* tab, const int* lab,
                                                  unsigned T, int label, unsigned s) {
  unsigned p = table_home(label, T);
  while (true) {
    unsigned* w = (unsigned*)tab + (p >> 1);
    const unsigned sh = (p & 1u) * 16u;
    unsigned old = *(volatile unsigned*)w;
    while (true) {
      const unsigned e = (old >> sh) & 0xffffu;
      if (e != kNoSlot && lab[e] != label) break;   // another label's: probe on
      if (e != kNoSlot && e <= s) return 1;          // a lower holder is in
      const unsigned want = (old & ~(0xffffu << sh)) | (s << sh);
      const unsigned got = atomicCAS(w, old, want);
      if (got == old) return e != kNoSlot;
      old = got;   // this entry or its neighbour changed: look again
    }
    p = next_pos(p, T);
  }
}

// Backward-shift deletion of the entry at i (linear probing keeps every
// chain unbroken without tombstones). One thread.
__device__ void table_erase(unsigned short* tab, const int* lab, unsigned T, unsigned i) {
  unsigned j = i;
  while (true) {
    j = next_pos(j, T);
    const unsigned e = tab[j];
    if (e == kNoSlot) break;
    const unsigned k = table_home(lab[e], T);
    // the entry stays where it is if its home lies cyclically in (i, j]
    const bool stays = i <= j ? (i < k && k <= j) : (i < k || k <= j);
    if (stays) continue;
    tab[i] = (unsigned short)e;
    i = j;
  }
  tab[i] = (unsigned short)kNoSlot;
}

// ---- warp-collective scans (warp 0, uniform arguments, uniform results)

// the lowest slot other than `skip` holding `label`, -1 if none
__device__ __noinline__ int other_holder(const int* lab, int bmax, int label, int skip,
                                            int lane) {
  unsigned best = kNone;
  for (int s = lane; s < bmax; s += 32)
    if (lab[s] == label && s != skip && (unsigned)s < best) best = s;
  best = __reduce_min_sync(REPRO_FULL_MASK, best);
  return best == kNone ? -1 : (int)best;
}

// the first set bit at or after `from`, bmax if none (bits past bmax are 0)
__device__ __forceinline__ int next_set(const unsigned* bits, int words, int from, int bmax,
                                        int lane) {
  const int w_from = from >> 5;
  for (int w0 = w_from; w0 < words; w0 += 32) {
    const int w = w0 + lane;
    unsigned v = w < words ? bits[w] : 0u;
    if (w == w_from) v &= ~0u << (from & 31);
    const unsigned any = __ballot_sync(REPRO_FULL_MASK, v != 0u);
    if (any) {
      const int l = __ffs(any) - 1;
      const unsigned vw = __shfl_sync(REPRO_FULL_MASK, v, l);
      return ((w0 + l) << 5) + __ffs(vw) - 1;
    }
  }
  return bmax;
}

// occupied slots below lim: lim less the empty bits below it
__device__ __forceinline__ int occupied_below(const unsigned* bits, int lim, int lane) {
  if (lim <= 0) return 0;
  const int whole = lim >> 5, rem = lim & 31;
  int empties = 0;
  for (int w = lane; w < whole; w += 32) empties += __popc(bits[w]);
  if (rem && lane == 0) empties += __popc(bits[whole] & ((1u << rem) - 1u));
  return lim - __reduce_add_sync(REPRO_FULL_MASK, empties);
}

// ---- block scans on demand: a miss on a full counter reads the minimum
// over the slots below B_t, RANDOM_EVICT's eviction its Gumbel row. Warp 0
// posts a request; the other warps, idle while it runs the chain, wait
// for requests at a named barrier and share the scan, so a scan of 4218
// slots is about 8 values a thread and three barriers, not 132 values a
// lane of one warp. Out of line: a lone warp has nothing to hide an
// instruction fetch behind, and a small loop stays in the cache.

enum ScanKind { kScanDone = 0, kScanMin = 1, kScanArgmax = 2 };

struct ScanReq {
  int kind;
  int n;            // counts [0, n) (kScanMin), or values p[j], j < n, at slots head + j
  int head;
  const float* p;   // a staged Gumbel buffer (shared) or a row in device memory
  int wait_bar;     // the staged buffer's mbarrier to observe first, -1 for none
  unsigned parity;
};

struct ScanParts {   // one entry a warp (at most 16 warps)
  float f[16];
  int i[16];
  unsigned u[16];
};

__device__ __forceinline__ void bar_named(int id, int nt) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nt) : "memory");
}

// The (count, slot) minimum over counts [0, n), all occupied (a miss on a
// full counter): (INT_MAX, slot 0) when n <= 0, as the masked argmin. Two
// passes: the least count, then the lowest slot holding it.
__device__ __noinline__ int2 block_min_count(const int* cnt, int n, ScanParts& parts) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int n4 = max(n, 0) >> 2;
  const int4* c4 = (const int4*)cnt;
  int m = INT_MAX;
  for (int q = tid; q < n4; q += nt) {
    const int4 v = c4[q];
    m = min(m, min(min(v.x, v.y), min(v.z, v.w)));
  }
  for (int s = 4 * n4 + tid; s < n; s += nt) m = min(m, cnt[s]);
  m = __reduce_min_sync(REPRO_FULL_MASK, m);
  if (lane == 0) parts.i[warp] = m;
  bar_named(2, nt);
  m = INT_MAX;
  for (int w = 0; w < nt >> 5; ++w) m = min(m, parts.i[w]);
  unsigned first = kNone;
  for (int q = tid; q < n4; q += nt) {
    const int4 v = c4[q];
    const unsigned s = 4 * q;
    first = min(first, v.w == m ? s + 3 : kNone);
    first = min(first, v.z == m ? s + 2 : kNone);
    first = min(first, v.y == m ? s + 1 : kNone);
    first = min(first, v.x == m ? s : kNone);
  }
  for (int s = 4 * n4 + tid; s < n; s += nt) first = min(first, cnt[s] == m ? s : kNone);
  first = __reduce_min_sync(REPRO_FULL_MASK, first);
  if (lane == 0) parts.u[warp] = first;
  bar_named(2, nt);
  first = kNone;
  for (int w = 0; w < nt >> 5; ++w) first = min(first, parts.u[w]);
  return make_int2(m, first == kNone ? 0 : (int)first);
}

// torch.argmax over a Gumbel row: values p[j], j < n, at slots head + j,
// and one more value xv at slot xs held by this thread (INT_MAX for none):
// the first NaN if any, else the lowest slot holding the maximum (-0.0 ==
// +0.0); slot 0 when there is no value. Two passes: the maximum and
// whether any value is NaN, then the lowest slot that matches.
__device__ __noinline__ int block_argmax(const float* p, int head, int n, int xs, float xv,
                                         ScanParts& parts) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  float m = xs != INT_MAX ? xv : -INFINITY;
  bool nan = xs != INT_MAX && isnan(xv);
  for (int j = tid; j < n; j += nt) {
    const float v = p[j];
    m = fmaxf(m, v);
    nan |= isnan(v);
  }
  m = warp_max(m);
  nan = __any_sync(REPRO_FULL_MASK, nan);
  if (lane == 0) {
    parts.f[warp] = m;
    parts.i[warp] = nan;
  }
  bar_named(2, nt);
  m = -INFINITY;
  nan = false;
  for (int w = 0; w < nt >> 5; ++w) {
    m = fmaxf(m, parts.f[w]);
    nan |= parts.i[w] != 0;
  }
  unsigned first = xs != INT_MAX && (nan ? isnan(xv) : xv == m) ? (unsigned)xs : kNone;
  for (int j = tid; j < n; j += nt) {
    const float v = p[j];
    first = min(first, (nan ? isnan(v) : v == m) ? (unsigned)(head + j) : kNone);
  }
  first = __reduce_min_sync(REPRO_FULL_MASK, first);
  if (lane == 0) parts.u[warp] = first;
  bar_named(2, nt);
  first = kNone;
  for (int w = 0; w < nt >> 5; ++w) first = min(first, parts.u[w]);
  return first == kNone ? 0 : (int)first;
}

// ---- TMA's 1-D bulk copy and its mbarrier
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// one thread: arm the barrier for `bytes` and start the copy
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  // the buffer's last reads (generic proxy) come before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// one 4-byte asynchronous copy into shared memory (Ampere's cp.async),
// and its group's commit and wait
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// global <-> shared copy of n ints, as 16-byte vectors where both ends
// allow, four loads in flight a thread before their stores
__device__ __forceinline__ void copy_ints(int* __restrict__ dst, const int* __restrict__ src,
                                          int n, int tid, int nt) {
  int s0 = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int q0 = tid; q0 < n4; q0 += 4 * nt) {
      int4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q0 + j * nt < n4) v[j] = ((const int4*)src)[q0 + j * nt];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q0 + j * nt < n4) ((int4*)dst)[q0 + j * nt] = v[j];
    }
    s0 = 4 * n4;
  }
  for (int s = s0 + tid; s < n; s += nt) dst[s] = src[s];
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__global__ void __launch_bounds__(512, 1) heavy_hitter_kernel(const __grid_constant__ HHArgs args) {
  const HHPtrs& g = args.p;
  const HHConf& a = args.c;
  // shared memory: every array starts on 16 bytes (heavy_hitter_plan's
  // layout, in the same order)
  extern __shared__ __align__(16) int smem[];
  const int bmax = a.bmax, bmax4 = round4(bmax);
  const int cells = a.policy == kCountMin ? a.cms_depth * a.cms_width : 0;
  const int words = (bmax + 31) >> 5;
  int* lab = smem;                                  // [bmax]
  int* cnt = lab + bmax4;                           // [bmax]
  int* sk = cnt + bmax4;                            // [depth * width] (COUNT_MIN)
  unsigned* bits = (unsigned*)(sk + round4(cells)); // [words] empty slots
  int* c_lab = (int*)bits + round4(words);          // [kChunk] label, then slot out
  int* c_u = c_lab + kChunk;                        // gate uniform, then evicted label
  int* c_m = c_u + kChunk;                          // Morris uniform, then the flags
  int* c_idx = c_m + kChunk;                        // arrival in the chunk | flags
  float* gbuf = (float*)(c_idx + kChunk);           // [2][bmax] (staged Gumbel rows)
  unsigned short* tab = (unsigned short*)(gbuf + (a.stage ? 2 * bmax4 : 0));
  const unsigned T = (unsigned)a.table;
  __shared__ __align__(8) unsigned long long bar[2];
  __shared__ int wcount[kChunk / 32];
  __shared__ int empties[32];   // a wave's next empty slots
  __shared__ int dup_sum;
  __shared__ int room_left;     // B_t less the occupied slots, as a chunk starts
  __shared__ float row_ends[2][8];   // a staged row's unaligned ends (lanes 0..5)
  __shared__ ScanReq scan_req;       // warp 0's request to the other warps
  __shared__ ScanParts parts;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const bool random = a.policy == kRandomEvict;

  // the scalars and the first chunk's arrivals, in flight while the state
  // comes in
  Scalars st;
  st.u = *g.admit_prob;
  if (warp == 0) {
    st.cap = *g.active_capacity;
    st.novel = *g.novel_in_window;
    st.seen = *g.seen_in_window;
    st.total_seen = *g.total_seen;
    st.evictions = *g.total_evictions;
    st.writes = *g.total_writes;
  }
  int pre_label = kEmpty, pre_prev = 0;
  float pre_u = 0.f, pre_m = 0.f;
  if (tid < kChunk && tid < a.B) {
    pre_label = g.labels[tid];
    pre_u = g.uniforms[tid];
    if (a.morris_on) pre_m = g.morris[tid];
    if (tid > 0) pre_prev = g.labels[tid - 1];
  }
  // ---- the state in; the table cleared; the barriers armed
  copy_ints(lab, g.slot_labels, bmax, tid, nt);
  copy_ints(cnt, g.slot_counts, bmax, tid, nt);
  if (cells) copy_ints(sk, g.cms, cells, tid, nt);
  for (int q = tid; q < (int)(T + 7) / 8; q += nt)
    ((int4*)tab)[q] = make_int4(-1, -1, -1, -1);
  if (tid == 0) {
    dup_sum = 0;
    if (a.stage) {
      mbar_init(&bar[0]);
      mbar_init(&bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  // ---- the table and the empty bitmap, in one pass: warp w takes words
  // w, w + nw, ..., lane l the slot 32 * word + l
  int dup = 0;
  for (int w = warp; w < words; w += nw) {
    const int s = 32 * w + lane;
    const int l = s < bmax ? lab[s] : 0;
    const unsigned empty = __ballot_sync(REPRO_FULL_MASK, s < bmax && l == kEmpty);
    if (lane == 0) bits[w] = empty;
    if (s < bmax && l >= 0) dup += table_build_insert(tab, lab, T, l, (unsigned)s);
  }
  dup = __reduce_add_sync(REPRO_FULL_MASK, dup);
  if (lane == 0 && dup) atomicAdd(&dup_sum, dup);
  __syncthreads();

  // ---- warp 0's registers: the scalars and the chain's bookkeeping
  int lim = 0, occ = 0, cursor = 0, dups = 0;
  unsigned issued = 0, used = 0;   // Gumbel rows started / consumed
  int xs0 = INT_MAX, xs1 = INT_MAX;   // the slot of a row's unaligned end (lanes 0..5)
  int hd0 = 0, hd1 = 0, ni0 = 0, ni1 = 0;   // a row's head floats, interior floats
  if (warp == 0) {
    lim = min(st.cap, bmax);
    occ = occupied_below(bits, lim, lane);
    cursor = next_set(bits, words, 0, bmax, lane);
    dups = dup_sum;
    if (lane == 0) room_left = st.cap - occ;
  }
  // the largest u_t the batch can reach (a uniform above it never passes
  // the gate, so its arrival never evicts); +inf where a shrink can raise u
  float u_top = st.u;
  if (a.adaptive) u_top = a.u_growth >= 1.f ? fmaxf(u_top, fmaxf(a.u_max, a.u0)) : INFINITY;

  for (int i0 = 0; i0 < a.B; i0 += kChunk) {
    // ---- stage the chunk: dropped arrivals' info now, valid ones compacted
    const int i = i0 + tid;
    int label = kEmpty, flags = tid;
    float u = 0.f, m = 0.f;
    bool valid = false;
    if (tid < kChunk && i < a.B) {
      int prev;
      if (i0 == 0) {
        label = pre_label;
        u = pre_u;
        m = pre_m;
        prev = pre_prev;
      } else {
        label = g.labels[i];
        u = g.uniforms[i];
        if (a.morris_on) m = g.morris[i];
        prev = g.labels[i - 1];
      }
      valid = label >= 0;
      if (valid) {
        if (i > 0 && prev < 0) flags |= kAfterDrop;
      } else {
        g.admitted[i] = 0;
        g.hit[i] = 0;
        g.evicted_label[i] = kEmpty;
        g.slot[i] = -1;
      }
    }
    const unsigned ballot = __ballot_sync(REPRO_FULL_MASK, valid);
    if (lane == 0 && warp < kChunk / 32) wcount[warp] = __popc(ballot);
    __syncthreads();
    int n_valid = 0, before = 0;
    for (int w = 0; w < kChunk / 32; ++w) {
      before += w < warp ? wcount[w] : 0;
      n_valid += wcount[w];
    }
    // a Gumbel row candidate: an arrival whose uniform can pass the gate,
    // in a chunk that can fill the counter (a non-adaptive B_t with room
    // for the whole chunk never fills within it)
    if (valid && a.stage && u <= u_top && (a.adaptive || room_left < kChunk)) flags |= kCand;
    if (valid) {
      const int k = before + __popc(ballot & ((1u << lane) - 1u));
      c_lab[k] = label;
      c_u[k] = __float_as_int(u);
      c_m[k] = __float_as_int(m);
      c_idx[k] = flags;
    }
    __syncthreads();

    if (warp == 0) {
      int scan = 0;   // where the search for the next candidate resumes
      // keep two candidates' Gumbel rows in flight
      auto issue_ahead = [&]() {
        while (issued - used < 2u) {
          while (scan < n_valid && !(c_idx[scan] & kCand)) ++scan;
          if (scan >= n_valid) break;
          const int at = i0 + (c_idx[scan] & 0xffff);
          const float* row = g.gumbel + (size_t)at * bmax;
          const uintptr_t r0 = (uintptr_t)row, r1 = r0 + 4 * (uintptr_t)bmax;
          const uintptr_t a0 = (r0 + 15) & ~(uintptr_t)15, a1 = r1 & ~(uintptr_t)15;
          const int head = (int)((a0 - r0) >> 2);
          const int inner = a1 > a0 ? (int)((a1 - a0) >> 2) : 0;
          int xs = INT_MAX;
          if (lane < 3) {
            if (lane < min(head, bmax)) xs = lane;
          } else if (lane < 6) {
            const int s = head + inner + (lane - 3);
            if (s < bmax) xs = s;
          }
          const int b = issued & 1;
          // the ends ride a 4-byte cp.async each, one commit group a row
          if (xs != INT_MAX) copy4_async(&row_ends[b][lane], row + xs);
          copy_async_commit();
          if (b) {
            xs1 = xs; hd1 = head; ni1 = inner;
          } else {
            xs0 = xs; hd0 = head; ni0 = inner;
          }
          if (lane == 0)
            bulk_load(gbuf + b * bmax4, (const void*)a0, 4u * (unsigned)inner, &bar[b]);
          ++issued;
          ++scan;
        }
      };
      if (a.stage) issue_ahead();

      // One arrival, k, in order (the transition that reads a minimum or a
      // Gumbel victim, or consumes a staged row). Every lane reads and
      // decides alike; lane 0 writes, between two __syncwarp.
      auto one_arrival = [&](const int k, const Probe pn) {   // pn: k's label, probed
        const int label = c_lab[k];
        const float u = __int_as_float(c_u[k]);
        const float mu = __int_as_float(c_m[k]);
        const int fl = c_idx[k];
        // ---- read phase: every lane, the same decisions
        const bool found = pn.slot >= 0 && pn.slot < lim;
        const bool has_room = occ < st.cap;
        const bool gate = u <= st.u;
        const bool admit_room = a.gate_below_capacity ? gate : true;
        int cms_est = 0;
        if (a.policy == kCountMin) {   // bumped for a valid label only
          cms_est = INT_MAX;
          for (int r = 0; r < a.cms_depth; ++r)
            cms_est = min(cms_est,
                          wrap_add(sk[r * a.cms_width + cms_col(label, r, a.cms_width)], 1));
        }
        const bool miss_full = !found && !has_room;
        int min_count = INT_MAX, victim = 0;
        if (miss_full && (a.policy == kSpaceSaving || a.policy == kCountMin ||
                          (a.policy == kMinEvict && gate))) {
          if (lane == 0) {
            scan_req.kind = kScanMin;
            scan_req.n = lim;
          }
          bar_named(1, nt);
          const int2 mv = block_min_count(cnt, lim, parts);
          min_count = mv.x;
          victim = mv.y;
        }
        bool admit_full;
        int evict_count = 1;
        if (a.policy == kRandomEvict || a.policy == kMinEvict) {
          admit_full = gate;
        } else if (a.policy == kSpaceSaving) {
          admit_full = true;
          evict_count = a.morris_on ? min_count : wrap_add(min_count, 1);
        } else {
          admit_full = cms_est >= wrap_add(min_count, 1);
        }
        const bool do_hit = found;
        const bool do_insert = !found && has_room && admit_room;
        const bool do_evict = miss_full && admit_full;
        const bool write = do_hit || do_insert || do_evict;
        const bool pick = random && do_evict;   // a Gumbel victim is read
        if (fl & kCand) {   // this arrival's staged row: wait, maybe read, release
          const int b = used & 1;
          for (unsigned spins = 0; !mbar_try_wait(&bar[b], (used >> 1) & 1u);)
            if (++spins == (1u << 28)) __trap();   // a copy that never lands: fail, not hang
          if (issued - used > 1u) copy_async_wait<1>();   // the next row's ends may fly on
          else copy_async_wait<0>();
          __syncwarp();
          if (pick) {
            const int head = b ? hd1 : hd0, inner = b ? ni1 : ni0;
            const int xs = b ? xs1 : xs0;
            const float xv = xs != INT_MAX ? row_ends[b][lane] : 0.f;
            const float* buf = gbuf + b * bmax4;
            const int n_in = max(min(inner, lim - head), 0);
            if (lane == 0) {
              scan_req = ScanReq{kScanArgmax, n_in, head, buf, b, (used >> 1) & 1u};
            }
            bar_named(1, nt);
            victim = block_argmax(buf, head, n_in, xs < lim ? xs : INT_MAX, xv, parts);
          }
          __syncwarp();
          ++used;
          issue_ahead();
        } else if (pick) {
          const float* row = g.gumbel + (size_t)(i0 + (fl & 0xffff)) * bmax;
          if (lane == 0) scan_req = ScanReq{kScanArgmax, max(lim, 0), 0, row, -1, 0u};
          bar_named(1, nt);
          victim = block_argmax(row, 0, max(lim, 0), INT_MAX, 0.f, parts);
        }
        const int slot = do_hit ? pn.slot : (do_insert ? (cursor < lim ? cursor : 0) : victim);
        int new_count = do_insert ? 1 : evict_count;
        if (do_hit) {
          const int c = cnt[slot];
          new_count = a.morris_on ? wrap_add(c, mu < exp2f(-(float)c) ? 1 : 0)
                                  : wrap_add(c, 1);
        }
        // a slot that changes hands: its old label leaves the table
        const int old = (do_insert || do_evict) ? lab[slot] : kEmpty;
        Probe po{0u, -1};
        int next_holder = -1;
        if (old >= 0) {
          po = probe(tab, lab, T, old);
          if (po.slot == slot && dups > 0) next_holder = other_holder(lab, bmax, old, slot, lane);
        }
        __syncwarp();
        // ---- write phase: lane 0
        if (lane == 0) {
          if (a.policy == kCountMin)
            for (int r = 0; r < a.cms_depth; ++r) {
              int* c = sk + r * a.cms_width + cms_col(label, r, a.cms_width);
              *c = wrap_add(*c, 1);
            }
          if (write) {
            if (old >= 0 && po.slot == slot) {
              if (next_holder >= 0) tab[po.pos] = (unsigned short)next_holder;
              else table_erase(tab, lab, T, po.pos);
            }
            lab[slot] = label;
            cnt[slot] = new_count;
            if (!do_hit) {   // the label's entry now names this slot (its lowest)
              const unsigned pos = old >= 0 ? probe(tab, lab, T, label).pos : pn.pos;
              tab[pos] = (unsigned short)slot;
              if (old == kEmpty) bits[slot >> 5] &= ~(1u << (slot & 31));
            }
          }
          c_lab[k] = write ? slot : -1;
          c_u[k] = do_evict ? old : kEmpty;
          c_m[k] = (do_insert || do_evict ? 1 : 0) | (do_hit ? 2 : 0);
        }
        __syncwarp();
        // ---- the registers, every lane alike
        if (write && !do_hit) {
          if (old >= 0 && (po.slot != slot || next_holder >= 0)) --dups;
          if (pn.slot >= 0) ++dups;
          if (old == kEmpty) {
            ++occ;
            if (slot == cursor) cursor = next_set(bits, words, slot + 1, bmax, lane);
          }
        }
        st.seen = wrap_add(st.seen, 1);
        st.novel = wrap_add(st.novel, found ? 0 : 1);
        const int cap0 = st.cap;
        window_step(a, st);
        if (st.cap != cap0) {
          lim = min(st.cap, bmax);
          occ = occupied_below(bits, lim, lane);
        }
        st.total_seen = wrap_add(st.total_seen, 1);
        st.evictions = wrap_add(st.evictions, do_evict ? 1 : 0);
        st.writes = wrap_add(st.writes, write ? 1 : 0);
      };

      bool after_alone = false;   // the last arrival went alone
      for (int k0 = 0; k0 < n_valid;) {
        if (c_idx[k0] & kAfterDrop) {   // the dropped run before k0: one step
          const int cap0 = st.cap;
          window_step(a, st);
          if (st.cap != cap0) {
            lim = min(st.cap, bmax);
            occ = occupied_below(bits, lim, lane);
          }
        }
        if (after_alone || (c_idx[k0] & kCand)) {
          // a staged row's arrival goes alone anyway; after an arrival that
          // went alone (a run of evictions), look at the next one first
          const Probe p0 = probe(tab, lab, T, c_lab[k0]);
          const bool found0 = p0.slot >= 0 && p0.slot < lim;
          if ((c_idx[k0] & kCand) ||
              (!found0 && occ >= st.cap &&
               (a.policy == kSpaceSaving || a.policy == kCountMin ||
                __int_as_float(c_u[k0]) <= st.u))) {
            one_arrival(k0, p0);
            ++k0;
            continue;
          }
        }
        // ---- a wave: lane j takes arrival k0 + j against the state as it is
        const int k = k0 + lane;
        const bool active = k < n_valid;
        const int label = active ? c_lab[k] : kEmpty;
        const int fl = active ? c_idx[k] : 0;
        const bool gate = active && __int_as_float(c_u[k]) <= st.u;
        const Probe pn = active ? probe(tab, lab, T, label) : Probe{0u, -1};
        const bool found = pn.slot >= 0 && pn.slot < lim;
        const bool has_room = occ < st.cap;
        // a miss on a full counter that may evict or reads the minimum, and
        // a staged row's arrival, go one at a time
        const bool alone = active && ((fl & kCand) ||
                                      (!found && !has_room &&
                                       (a.policy == kSpaceSaving || a.policy == kCountMin ||
                                        gate)));
        const unsigned cut = __ballot_sync(REPRO_FULL_MASK, alone);
        int g = min(n_valid - k0, 32);
        if (cut) g = min(g, __ffs(cut) - 1);
        // the arrival that closes the adaptive window ends the wave (so within
        // a wave `seen` stays below the window, and a dropped run before any
        // lane but the first cannot close it: its step is a no-op)
        if (a.adaptive) g = min(g, max(a.window - st.seen, 1));
        // the first arrival of each missing label that may insert inserts;
        // its label's later arrivals in the wave hit the slot it fills
        const bool miss = lane < g && !found;
        const bool may_insert = miss && has_room && (a.gate_below_capacity ? gate : true);
        const unsigned may_any = __ballot_sync(REPRO_FULL_MASK, may_insert);
        int inserter = 32;
        if (may_any) {
          const unsigned may =
              may_any & __match_any_sync(REPRO_FULL_MASK, miss ? label : -1 - lane);
          inserter = may ? __ffs(may) - 1 : 32;
        }
        unsigned ins = __ballot_sync(REPRO_FULL_MASK, miss && lane == inserter);
        int n_empty = 0;
        if (ins) {   // the next empty slots, in order, from the cursor's word
          const int w = (cursor >> 5) + lane;
          unsigned v = w < words ? bits[w] : 0u;
          const int n = __popc(v);
          int incl = n;
          for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(REPRO_FULL_MASK, incl, o);
            if (lane >= o) incl += t;
          }
          const int need = min(__popc(ins) + 1, 32);   // the inserts' slots and the next
          for (int r = incl - n; v && r < need; ++r) {
            empties[r] = 32 * w + __ffs(v) - 1;
            v &= v - 1;
          }
          n_empty = min(__shfl_sync(REPRO_FULL_MASK, incl, 31), need);
          __syncwarp();
          // inserts stop where the counter fills or the empty slots below B_t run out
          const int room = st.cap - occ;
          const int below = __popc(__ballot_sync(REPRO_FULL_MASK,
                                                 lane < n_empty && empties[lane] < lim));
          const int allowed = min(below, room);
          if (allowed == room && __popc(ins) >= room) {
            g = __fns(ins, 0, room) + 1;   // the counter is full after this insert
            ins &= g < 32 ? (1u << g) - 1u : ~0u;
          } else if (__popc(ins) > allowed) {
            g = __fns(ins, 0, allowed + 1);   // no empty slot below B_t for this one
            ins &= (1u << g) - 1u;
          }
        }
        after_alone = g == 0;
        if (g == 0) {
          one_arrival(k0, Probe{__shfl_sync(REPRO_FULL_MASK, pn.pos, 0),
                                __shfl_sync(REPRO_FULL_MASK, pn.slot, 0)});
          ++k0;
          continue;
        }
        const bool in = lane < g;
        const bool inserts = in && ((ins >> lane) & 1u);
        const bool hit = in && (found || inserter < lane);
        const int islot = inserts ? empties[__popc(ins & ((1u << lane) - 1u))] : 0;
        const int from_inserter = __shfl_sync(REPRO_FULL_MASK, islot, inserter & 31);
        const int slot = found ? pn.slot : (inserts ? islot : from_inserter);
        const bool writes = hit || inserts;
        if (inserts) {   // before a table entry names the slot
          lab[islot] = label;
          if (!a.morris_on) cnt[islot] = 1;
        }
        __syncwarp();
        int existed = 0;
        if (inserts) {
          existed = table_build_insert(tab, lab, T, label, (unsigned)islot);
          atomicAnd(&bits[islot >> 5], ~(1u << (islot & 31)));
        }
        if (in && a.policy == kCountMin)
          for (int r = 0; r < a.cms_depth; ++r)
            atomicAdd(&sk[r * a.cms_width + cms_col(label, r, a.cms_width)], 1);
        if (!a.morris_on) {   // exact counts: every hit adds one, in any order
          if (hit) atomicAdd(&cnt[slot], 1);
        } else {   // Morris: each slot's lowest writer steps its count in arrival order
          const unsigned wsame = __match_any_sync(REPRO_FULL_MASK, writes ? slot : -1 - lane);
          if (writes && lane == __ffs(wsame) - 1) {
            int c = inserts ? 1 : cnt[slot];
            for (unsigned rest = inserts ? wsame & (wsame - 1u) : wsame; rest;
                 rest &= rest - 1u) {
              const float mu = __int_as_float(c_m[k0 + __ffs(rest) - 1]);
              c = wrap_add(c, mu < exp2f(-(float)c) ? 1 : 0);
            }
            cnt[slot] = c;
          }
        }
        __syncwarp();
        if (in) {
          c_lab[k] = writes ? slot : -1;
          c_u[k] = kEmpty;
          c_m[k] = (inserts ? 1 : 0) | (hit ? 2 : 0);
        }
        // ---- the registers, every lane alike
        const int n_ins = __popc(ins);
        dups += __reduce_add_sync(REPRO_FULL_MASK, existed);
        occ += n_ins;
        if (n_ins)
          cursor = n_ins < n_empty ? empties[n_ins]
                                   : next_set(bits, words, empties[n_ins - 1] + 1, bmax, lane);
        st.seen = wrap_add(st.seen, g);
        st.novel = wrap_add(st.novel, __popc(__ballot_sync(REPRO_FULL_MASK, in && !hit)));
        st.total_seen = wrap_add(st.total_seen, g);
        st.writes = wrap_add(st.writes, __popc(__ballot_sync(REPRO_FULL_MASK, writes)));
        const int cap0 = st.cap;
        window_step(a, st);
        if (st.cap != cap0) {
          lim = min(st.cap, bmax);
          occ = occupied_below(bits, lim, lane);
        }
        __syncwarp();
        k0 += g;
      }
      if (lane == 0) {
        room_left = st.cap - occ;
        scan_req.kind = kScanDone;
      }
      bar_named(1, nt);
    } else {   // the other warps serve warp 0's scans until its chain is done
      for (;;) {
        bar_named(1, nt);
        const ScanReq r = scan_req;
        if (r.kind == kScanDone) break;
        if (r.kind == kScanMin) {
          block_min_count(cnt, r.n, parts);
        } else {
          if (r.wait_bar >= 0)   // a staged row: its copy has landed (warp 0 saw it too)
            while (!mbar_try_wait(&bar[r.wait_bar], r.parity)) {
            }
          block_argmax(r.p, r.head, r.n, INT_MAX, 0.f, parts);
        }
      }
    }
    __syncthreads();
    // ---- the valid arrivals' info, in parallel
    for (int k = tid; k < n_valid; k += nt) {
      const int at = i0 + (c_idx[k] & 0xffff);
      const int f = c_m[k];
      g.admitted[at] = f & 1;
      g.hit[at] = (f >> 1) & 1;
      g.evicted_label[at] = c_u[k];
      g.slot[at] = c_lab[k];
    }
    __syncthreads();   // the chunk's arrays are free again
  }
  // a dropped run that ends the batch takes its one window step
  if (warp == 0 && a.B > 0 && g.labels[a.B - 1] < 0) window_step(a, st);

  // ---- the state out
  copy_ints(g.out_labels, lab, bmax, tid, nt);
  copy_ints(g.out_counts, cnt, bmax, tid, nt);
  if (cells) copy_ints(g.out_cms, sk, cells, tid, nt);
  if (tid == 0) {
    *g.out_admit_prob = st.u;
    *g.out_active_capacity = st.cap;
    *g.out_novel_in_window = st.novel;
    *g.out_seen_in_window = st.seen;
    *g.out_total_seen = st.total_seen;
    *g.out_total_evictions = st.evictions;
    *g.out_total_writes = st.writes;
  }
}

}  // namespace

// threads and smem (dynamic bytes: the slots, the sketch, the bitmap, the
// staged chunk, the Gumbel buffers, the table) are the wrapper's plan.
extern "C" int heavy_hitter_launch(const HHPtrs* ptrs, const HHConf* conf, int threads,
                                   long long smem, void* stream) {
  cudaError_t err = allow_smem(heavy_hitter_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const HHArgs args{*ptrs, *conf};
  heavy_hitter_kernel<<<1, threads, (size_t)smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
