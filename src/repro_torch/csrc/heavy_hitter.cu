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
// for RANDOM_EVICT the Gumbel rows (4.3 MB at 256 x 4218); it writes the
// state and 10 B bytes of info. The work is a serial chain: one block
// takes the arrivals in order, and each valid arrival costs one fused
// block reduction (two barriers) plus one thread's transition.
//
// Design: one block. labels, counts and, for COUNT_MIN, the sketch live
// in shared memory (dynamic, past 48 KB by the opt-in), beside a chunk of
// blockDim arrivals' labels and draws staged from global memory. A
// dropped arrival (label < 0) touches no slot: thread 0 alone takes its
// step (the adaptive window may still close on it) and the block goes on
// without a barrier. A valid arrival: every thread scans its slots below
// B_t (the active capacity; no slot at or past it counts) for the first
// hit, the occupied count, the first empty slot, the (count, slot)
// minimum over occupied slots and, for RANDOM_EVICT, the Gumbel argmax
// over them; warps reduce with __reduce_*_sync and 64-bit key shuffles,
// warp 0 reduces the warps' partials, and its lane 0 applies the
// transition. The wrapper's plan (kernels/heavy_hitter/heavy_hitter.py::
// heavy_hitter_plan) sizes the block and refuses a bmax past shared memory.
#include "common.cuh"

namespace {

constexpr int kEmpty = -1;
constexpr unsigned kNone = 0xffffffffu;  // "no slot" in a min reduction
enum Policy { kRandomEvict = 0, kMinEvict = 1, kSpaceSaving = 2, kCountMin = 3 };

typedef unsigned long long key64;

}  // namespace

// Field order and types are mirrored by the ctypes Structure in
// kernels/heavy_hitter/heavy_hitter.py.
struct HHArgs {
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
  // the config
  int B, bmax, policy, morris_on, gate_below_capacity, adaptive;
  int capacity, cms_depth, cms_width, window, b_step;
  float u0, novel_hi, novel_lo, u_growth, u_max;
};

namespace {

// The scalar state, held by the block while it runs (thread 0 writes it).
struct Scalars {
  float u;
  int cap, novel, seen, total_seen, evictions, writes;
};

// One warp's (then the block's) partial reduction of a valid arrival.
struct Partial {
  unsigned hit;    // first slot holding the label, kNone if none
  unsigned occ;    // occupied slots below B_t
  unsigned empty;  // first empty slot below B_t, kNone if none
  key64 min_key;   // (count, slot) minimum over occupied slots
  key64 g_key;     // (Gumbel, lowest slot) maximum over occupied slots
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// (count, slot) as a key whose unsigned order is count first (signed),
// then slot; an unoccupied slot counts as INT_MAX, as in the plain
// version's argmin over where(occ, counts, INT_MAX).
__device__ __forceinline__ key64 min_key(int count, unsigned slot) {
  return ((key64)((unsigned)count ^ 0x80000000u) << 32) | slot;
}

// (value, slot) as a key whose unsigned order is value first (NaN above
// everything, -0.0 == +0.0), then the lower slot: torch.argmax's order.
__device__ __forceinline__ key64 max_key(float v, unsigned slot) {
  unsigned o;
  if (isnan(v)) {
    o = 0xffffffffu;
  } else {
    const unsigned b = __float_as_uint(v + 0.0f);
    o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return ((key64)o << 32) | (key64)(0xffffffffu - slot);
}

__device__ __forceinline__ key64 shfl_min(key64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    const key64 w = __shfl_xor_sync(REPRO_FULL_MASK, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__device__ __forceinline__ key64 shfl_max(key64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    const key64 w = __shfl_xor_sync(REPRO_FULL_MASK, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ __forceinline__ Partial warp_reduce(Partial p, bool gumbel) {
  p.hit = __reduce_min_sync(REPRO_FULL_MASK, p.hit);
  p.occ = __reduce_add_sync(REPRO_FULL_MASK, p.occ);
  p.empty = __reduce_min_sync(REPRO_FULL_MASK, p.empty);
  p.min_key = shfl_min(p.min_key);
  if (gumbel) p.g_key = shfl_max(p.g_key);
  return p;
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
__device__ __forceinline__ void window_step(const HHArgs& a, Scalars& s) {
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

__global__ void heavy_hitter_kernel(const HHArgs a) {
  extern __shared__ int smem[];
  int* lab = smem;                       // [bmax]
  int* cnt = lab + a.bmax;               // [bmax]
  int* sk = cnt + a.bmax;                // [depth * width] (COUNT_MIN)
  const int cells = a.policy == kCountMin ? a.cms_depth * a.cms_width : 0;
  int* chunk_label = sk + cells;         // [blockDim]
  float* chunk_u = (float*)(chunk_label + blockDim.x);
  float* chunk_m = chunk_u + blockDim.x;
  __shared__ Partial warp_part[32];
  __shared__ Scalars st;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const bool gumbel = a.policy == kRandomEvict;
  for (int s = tid; s < a.bmax; s += nt) {
    lab[s] = a.slot_labels[s];
    cnt[s] = a.slot_counts[s];
  }
  for (int c = tid; c < cells; c += nt) sk[c] = a.cms[c];
  if (tid == 0) {
    st.u = *a.admit_prob;
    st.cap = *a.active_capacity;
    st.novel = *a.novel_in_window;
    st.seen = *a.seen_in_window;
    st.total_seen = *a.total_seen;
    st.evictions = *a.total_evictions;
    st.writes = *a.total_writes;
  }

  for (int i0 = 0; i0 < a.B; i0 += nt) {
    __syncthreads();  // the last chunk's labels and draws are read
    const int i = i0 + tid;
    chunk_label[tid] = i < a.B ? a.labels[i] : kEmpty;
    chunk_u[tid] = i < a.B ? a.uniforms[i] : 0.f;
    chunk_m[tid] = (i < a.B && a.morris_on) ? a.morris[i] : 0.f;
    __syncthreads();
    const int n = min(nt, a.B - i0);
    for (int j = 0; j < n; ++j) {
      const int label = chunk_label[j];
      const int at = i0 + j;
      if (label < 0) {  // block-uniform: a dropped arrival writes no slot
        if (tid == 0) {
          window_step(a, st);
          a.admitted[at] = 0;
          a.hit[at] = 0;
          a.evicted_label[at] = kEmpty;
          a.slot[at] = -1;
        }
        continue;
      }
      __syncthreads();  // the previous arrival's transition is visible
      const int lim = min(st.cap, a.bmax);
      Partial p{kNone, 0u, kNone, min_key(INT_MAX, kNone), max_key(-INFINITY, kNone)};
      const float* g_row = gumbel ? a.gumbel + (size_t)at * a.bmax : nullptr;
      // an unoccupied slot enters the minimum as INT_MAX and the Gumbel
      // maximum as -inf, as in the plain version's masked argmin / argmax
      // (slots at or past B_t would too, but a lower slot always ties them)
      for (int s = tid; s < lim; s += nt) {
        const int l = lab[s];
        const bool occ = l != kEmpty;
        if (!occ && p.empty == kNone) p.empty = s;
        if (occ && l == label && p.hit == kNone) p.hit = s;
        p.occ += occ;
        const key64 mk = min_key(occ ? cnt[s] : INT_MAX, s);
        if (mk < p.min_key) p.min_key = mk;
        if (gumbel) {
          const key64 gk = max_key(occ ? g_row[s] : -INFINITY, s);
          if (gk > p.g_key) p.g_key = gk;
        }
      }
      p = warp_reduce(p, gumbel);
      if (lane == 0) warp_part[warp] = p;
      __syncthreads();
      if (warp != 0) continue;
      Partial q = lane < nw ? warp_part[lane]
                            : Partial{kNone, 0u, kNone, min_key(INT_MAX, kNone),
                                      max_key(-INFINITY, kNone)};
      q = warp_reduce(q, gumbel);
      if (lane != 0) continue;

      // ---- the transition, one thread (update_one's composition)
      const bool found = q.hit != kNone;
      const int hit_slot = found ? (int)q.hit : 0;
      const bool has_room = (int)q.occ < st.cap;
      const int empty_slot = q.empty != kNone ? (int)q.empty : 0;
      // an empty mask's argmin / argmax is slot 0 (INT_MAX / -inf there)
      const int min_count = (int)((unsigned)(q.min_key >> 32) ^ 0x80000000u);
      const int min_slot = (unsigned)q.min_key == kNone ? 0 : (int)(unsigned)q.min_key;
      const unsigned g_slot = 0xffffffffu - (unsigned)q.g_key;
      const int g_victim = g_slot == kNone ? 0 : (int)g_slot;

      const float u = chunk_u[j];
      const bool gate = u <= st.u;
      const bool admit_room = a.gate_below_capacity ? gate : true;
      int cms_est = 0;
      if (a.policy == kCountMin) {  // bumped for a valid label only
        cms_est = INT_MAX;
        for (int r = 0; r < a.cms_depth; ++r) {
          int* c = sk + r * a.cms_width + cms_col(label, r, a.cms_width);
          *c = wrap_add(*c, 1);
          cms_est = min(cms_est, *c);
        }
      }
      int victim, evict_count = 1;
      bool admit_full;
      if (a.policy == kRandomEvict) {
        victim = g_victim;
        admit_full = gate;
      } else if (a.policy == kMinEvict) {
        victim = min_slot;
        admit_full = gate;
      } else if (a.policy == kSpaceSaving) {
        victim = min_slot;
        admit_full = true;
        evict_count = a.morris_on ? min_count : wrap_add(min_count, 1);
      } else {
        victim = min_slot;
        admit_full = cms_est >= wrap_add(min_count, 1);
      }
      const int c_hit = cnt[hit_slot];
      const int hit_count =
          a.morris_on ? wrap_add(c_hit, chunk_m[j] < exp2f(-(float)c_hit) ? 1 : 0)
                      : wrap_add(c_hit, 1);
      const bool do_hit = found;
      const bool do_insert = !found && has_room && admit_room;
      const bool do_evict = !found && !has_room && admit_full;
      const bool write = do_hit || do_insert || do_evict;
      const int slot = do_hit ? hit_slot : (do_insert ? empty_slot : victim);
      const int evicted = do_evict ? lab[victim] : kEmpty;
      if (write) {
        lab[slot] = label;
        cnt[slot] = do_hit ? hit_count : (do_insert ? 1 : evict_count);
      }
      st.seen = wrap_add(st.seen, 1);
      st.novel = wrap_add(st.novel, found ? 0 : 1);
      window_step(a, st);
      st.total_seen = wrap_add(st.total_seen, 1);
      st.evictions = wrap_add(st.evictions, do_evict ? 1 : 0);
      st.writes = wrap_add(st.writes, write ? 1 : 0);
      a.admitted[at] = do_insert || do_evict;
      a.hit[at] = do_hit;
      a.evicted_label[at] = evicted;
      a.slot[at] = write ? slot : -1;
    }
  }
  __syncthreads();
  for (int s = tid; s < a.bmax; s += nt) {
    a.out_labels[s] = lab[s];
    a.out_counts[s] = cnt[s];
  }
  for (int c = tid; c < cells; c += nt) a.out_cms[c] = sk[c];
  if (tid == 0) {
    *a.out_admit_prob = st.u;
    *a.out_active_capacity = st.cap;
    *a.out_novel_in_window = st.novel;
    *a.out_seen_in_window = st.seen;
    *a.out_total_seen = st.total_seen;
    *a.out_total_evictions = st.evictions;
    *a.out_total_writes = st.writes;
  }
}

}  // namespace

// threads and smem (dynamic bytes: the slots, the sketch, the staged
// chunk) are the wrapper's plan.
extern "C" int heavy_hitter_launch(const HHArgs* args, int threads, long long smem,
                                   void* stream) {
  cudaError_t err = allow_smem(heavy_hitter_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  heavy_hitter_kernel<<<1, threads, (size_t)smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
