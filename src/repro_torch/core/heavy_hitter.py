"""Counter-based streaming heavy-hitter filter (paper §Streaming Heavy-Hitter
Filtering) as dense tensors.

The counter is two vectors, ``labels[bmax]`` (−1 = empty) and
``counts[bmax]``; membership, min and eviction are branch-free
``torch.where`` ops over them, so the per-arrival loop never reads a
value back to the host. Policies (paper Table 8): RANDOM_EVICT,
MIN_EVICT, SPACE_SAVING, COUNT_MIN; exact or Morris counts; adaptive
u_t/B_t (paper Table 9).

Random draws are explicit arguments: per-arrival gate uniforms ``[B]``,
plus Gumbel noise ``[B, bmax]`` (RANDOM_EVICT) and Morris uniforms ``[B]``
where those are on. When the caller passes none they are drawn from a
``torch.Generator``. ``update_batch`` runs the microbatch through
``kernels/heavy_hitter`` (the kernel on a card, a loop of ``update_one``
on the CPU).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import torch

from repro_torch.kernels.common import stable_topk

INT_MAX = 2**31 - 1
EMPTY = -1
_U32 = 0xFFFFFFFF


class Policy(enum.IntEnum):
    RANDOM_EVICT = 0
    MIN_EVICT = 1
    SPACE_SAVING = 2
    COUNT_MIN = 3


@dataclasses.dataclass(frozen=True)
class HHConfig:
    """Static heavy-hitter configuration (paper Table 2 defaults)."""

    capacity: int = 100              # B
    admit_prob: float = 0.05         # u
    policy: Policy = Policy.MIN_EVICT
    morris: bool = False             # Morris approximate counters
    gate_below_capacity: bool = False
    cms_depth: int = 4
    cms_width: int = 256
    adaptive: bool = False
    max_capacity: int | None = None  # B_max when adaptive (>= capacity)
    window: int = 256                # novelty-rate window (arrivals)
    novel_hi: float = 0.5
    novel_lo: float = 0.1
    u_growth: float = 2.0
    u_max: float = 0.5
    b_step: int = 16

    def __post_init__(self):
        for name in ("capacity", "cms_depth", "cms_width", "window"):
            if getattr(self, name) <= 0:
                raise ValueError(f"HHConfig.{name} must be positive, got "
                                 f"{getattr(self, name)}")
        if self.max_capacity is not None and self.max_capacity <= 0:
            raise ValueError("HHConfig.max_capacity must be positive when "
                             f"set, got {self.max_capacity}")

    def bmax(self) -> int:
        if self.adaptive and self.max_capacity is not None:
            return max(self.max_capacity, self.capacity)
        return self.capacity


class HHState(NamedTuple):
    labels: torch.Tensor           # [bmax] i32, EMPTY where unoccupied
    counts: torch.Tensor           # [bmax] i32 (Morris: exponent c)
    cms: torch.Tensor              # [depth, width] i32 Count-Min sketch
    admit_prob: torch.Tensor       # f32 scalar u_t
    active_capacity: torch.Tensor  # i32 scalar B_t <= bmax
    novel_in_window: torch.Tensor  # i32 scalar
    seen_in_window: torch.Tensor   # i32 scalar
    total_seen: torch.Tensor       # i32 scalar
    total_evictions: torch.Tensor  # i32 scalar
    total_writes: torch.Tensor     # i32 scalar


def init(cfg: HHConfig, device) -> HHState:
    bmax = cfg.bmax()

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return HHState(
        labels=torch.full((bmax,), EMPTY, dtype=torch.int32, device=device),
        counts=torch.zeros((bmax,), dtype=torch.int32, device=device),
        cms=torch.zeros((cfg.cms_depth, cfg.cms_width), dtype=torch.int32,
                        device=device),
        admit_prob=torch.tensor(cfg.admit_prob, dtype=torch.float32,
                                device=device),
        active_capacity=i32(cfg.capacity),
        novel_in_window=i32(0), seen_in_window=i32(0), total_seen=i32(0),
        total_evictions=i32(0), total_writes=i32(0))


def estimated_counts(cfg: HHConfig, state: HHState) -> torch.Tensor:
    """Exact counts, or the Morris estimate 2^c − 1."""
    if cfg.morris:
        return torch.exp2(state.counts.to(torch.float32)) - 1.0
    return state.counts.to(torch.float32)


def active_mask(state: HHState) -> torch.Tensor:
    slot = torch.arange(state.labels.shape[0], device=state.labels.device)
    return (state.labels != EMPTY) & (slot < state.active_capacity)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32) without overflowing
    int64: split ``b`` into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _cms_hash(label: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """The reference's uint32 hash, one column per sketch row, in int64."""
    seeds = _mul32(torch.arange(1, depth + 1, dtype=torch.int64,
                                device=label.device), 0x9E3779B1)
    h = _mul32((label.to(torch.int64) & _U32) + seeds & _U32, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h % width


def _at(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``v[i]`` for a 0-d index tensor, as a gather (no host read)."""
    return v.gather(0, i.reshape(1)).reshape(())


def update_one(cfg: HHConfig, state: HHState, label: torch.Tensor,
               u: torch.Tensor, gumbel: torch.Tensor | None = None,
               morris_u: torch.Tensor | None = None,
               slot_ids: torch.Tensor | None = None):
    """One arrival. ``label`` < 0 means the item was dropped upstream (a
    no-op). ``u`` is the gate uniform; ``gumbel`` [bmax] (RANDOM_EVICT)
    and ``morris_u`` (Morris) the other draws. Returns (new_state, info)
    with info = {admitted, hit, evicted_label, slot}."""
    bmax = state.labels.shape[0]
    if slot_ids is None:
        slot_ids = torch.arange(bmax, device=state.labels.device)
    labels, counts = state.labels, state.counts

    valid = label >= 0
    in_cap = slot_ids < state.active_capacity
    occ = (labels != EMPTY) & in_cap
    hit_vec = occ & (labels == label)
    found = hit_vec.any()
    hit_slot = torch.argmax(hit_vec.to(torch.int32))
    has_room = occ.sum() < state.active_capacity
    empty_slot = torch.argmax(((labels == EMPTY) & in_cap).to(torch.int32))

    gate = u <= state.admit_prob
    admit_room = gate if cfg.gate_below_capacity else True

    if cfg.policy == Policy.COUNT_MIN:
        rows = torch.arange(cfg.cms_depth, device=labels.device)
        cols = _cms_hash(label, cfg.cms_depth, cfg.cms_width)
        bumped = state.cms.clone()
        bumped[rows, cols] += 1
        cms_est = bumped[rows, cols].min()
        new_cms = torch.where(valid, bumped, state.cms)
    else:
        new_cms = state.cms

    counts_f = torch.where(occ, counts, INT_MAX)   # min over occupied
    min_slot = torch.argmin(counts_f)
    min_count = _at(counts_f, min_slot)

    if cfg.policy == Policy.RANDOM_EVICT:
        # uniform over occupied slots via Gumbel-max on the mask
        victim = torch.argmax(torch.where(occ, gumbel, -torch.inf))
        admit_full = gate
        evict_count = 1
    elif cfg.policy == Policy.MIN_EVICT:
        victim, admit_full, evict_count = min_slot, gate, 1
    elif cfg.policy == Policy.SPACE_SAVING:
        victim, admit_full = min_slot, True   # always replaces the min
        evict_count = min_count if cfg.morris else min_count + 1
    else:  # COUNT_MIN
        victim, admit_full, evict_count = min_slot, cms_est >= min_count + 1, 1

    c_hit = _at(counts, hit_slot)
    if cfg.morris:
        hit_count = c_hit + (morris_u < torch.exp2(
            -c_hit.to(torch.float32))).to(torch.int32)
    else:
        hit_count = c_hit + 1

    do_hit = valid & found
    do_insert = valid & ~found & has_room & admit_room
    do_evict = valid & ~found & ~has_room & admit_full

    slot = torch.where(do_hit, hit_slot,
                       torch.where(do_insert, empty_slot, victim))
    write = do_hit | do_insert | do_evict
    new_cnt = torch.where(do_hit, hit_count,
                          torch.where(do_insert, 1, evict_count))
    at = write & (slot_ids == slot)
    new_labels = torch.where(at, label.to(torch.int32), labels)
    new_counts = torch.where(at, new_cnt.to(torch.int32), counts)
    evicted_label = torch.where(do_evict, _at(labels, victim), EMPTY)

    novel = valid & ~found
    seen_w = state.seen_in_window + valid.to(torch.int32)
    novel_w = state.novel_in_window + novel.to(torch.int32)
    admit_prob, active_capacity = state.admit_prob, state.active_capacity
    if cfg.adaptive:
        window_done = seen_w >= cfg.window
        rate = (novel_w.to(torch.float32)
                / torch.clamp(seen_w, min=1).to(torch.float32))
        grow = window_done & (rate > cfg.novel_hi)
        shrink = window_done & (rate < cfg.novel_lo)
        admit_prob = torch.where(
            grow, torch.clamp(admit_prob * cfg.u_growth, max=cfg.u_max),
            torch.where(shrink,
                        torch.clamp(admit_prob / cfg.u_growth,
                                    min=cfg.admit_prob),
                        admit_prob))
        active_capacity = torch.where(
            grow, torch.clamp(active_capacity + cfg.b_step, max=bmax),
            torch.where(shrink,
                        torch.clamp(active_capacity - cfg.b_step,
                                    min=cfg.capacity),
                        active_capacity)).to(torch.int32)
        seen_w = torch.where(window_done, 0, seen_w)
        novel_w = torch.where(window_done, 0, novel_w)

    new_state = HHState(
        labels=new_labels, counts=new_counts, cms=new_cms,
        admit_prob=admit_prob, active_capacity=active_capacity,
        novel_in_window=novel_w, seen_in_window=seen_w,
        total_seen=state.total_seen + valid.to(torch.int32),
        total_evictions=state.total_evictions + do_evict.to(torch.int32),
        total_writes=state.total_writes + write.to(torch.int32))
    info = {
        "admitted": do_insert | do_evict,
        "hit": do_hit,
        "evicted_label": evicted_label,
        "slot": torch.where(write, slot, -1),
    }
    return new_state, info


def draw(cfg: HHConfig, n: int, gen: torch.Generator, device) -> dict:
    """The per-arrival random draws for ``n`` arrivals from ``gen``."""
    out = {"uniforms": torch.rand((n,), generator=gen, device=device)}
    if cfg.policy == Policy.RANDOM_EVICT:
        u = torch.rand((n, cfg.bmax()), generator=gen, device=device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        out["gumbel"] = -torch.log(-torch.log(u))
    if cfg.morris:
        out["morris"] = torch.rand((n,), generator=gen, device=device)
    return out


def update_batch(cfg: HHConfig, state: HHState, labels: torch.Tensor,
                 gen: torch.Generator | None = None,
                 draws: dict | None = None):
    """The per-arrival update over a microbatch, in order (paper
    semantics exact): the ``heavy_hitter`` kernel on a card, its plain
    version (a Python loop of ``update_one``) on the CPU.

    labels: [B] i32 cluster labels, −1 for upstream-dropped items.
    ``draws`` = {"uniforms": [B], "gumbel": [B, bmax], "morris": [B]}
    (the last two where the config uses them), on the labels' device;
    drawn from ``gen`` when None. Returns (new_state, info dict of [B]
    tensors: admitted, hit, evicted_label, slot)."""
    from repro_torch.kernels.heavy_hitter import ops  # its ref.py imports this module

    if draws is None:
        draws = draw(cfg, labels.shape[0], gen, labels.device)
    return ops.update_batch(cfg, state, labels, draws)


def merge(cfg: HHConfig, a: HHState, b: HHState) -> HHState:
    """Merge two shard-local counters into one (the label union with
    summed estimated counts, top-``bmax`` kept), on ``a``'s device.

    As the reference: duplicate labels are summed over runs of a stable
    sort by label, then the top ``bmax`` counts are kept with ties to the
    lowest position (a stable descending sort: ``torch.topk`` promises
    no tie order); Morris counts go back to exponents
    ``ceil(log2(c + 1))``."""
    b = HHState(*(t.to(a.labels.device) for t in b))
    labels = torch.cat([a.labels, b.labels])
    counts = torch.cat([estimated_counts(cfg, a), estimated_counts(cfg, b)])
    occ = torch.cat([active_mask(a), active_mask(b)])
    counts = torch.where(occ, counts, 0.0)
    labels = torch.where(occ, labels, EMPTY)

    order = torch.argsort(labels, stable=True)
    sl, sc = labels[order], counts[order]
    first = torch.ones_like(sl, dtype=torch.bool)
    first[1:] = sl[1:] != sl[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    summed = torch.zeros_like(sc).index_add_(0, seg, sc)
    uniq_label = torch.where(first, sl, EMPTY)
    uniq_count = torch.where(first & (sl != EMPTY), summed[seg], 0.0)

    bmax = a.labels.shape[0]
    top_count, top_idx = stable_topk(uniq_count, bmax)
    keep = top_count > 0
    out_counts = torch.where(keep, top_count, 0.0)
    if cfg.morris:
        out_counts = torch.ceil(torch.log2(out_counts + 1.0))
    return HHState(
        labels=torch.where(keep, uniq_label[top_idx], EMPTY).to(torch.int32),
        counts=out_counts.to(torch.int32),
        cms=a.cms + b.cms,
        admit_prob=torch.maximum(a.admit_prob, b.admit_prob),
        active_capacity=torch.maximum(a.active_capacity, b.active_capacity),
        novel_in_window=a.novel_in_window + b.novel_in_window,
        seen_in_window=a.seen_in_window + b.seen_in_window,
        total_seen=a.total_seen + b.total_seen,
        total_evictions=a.total_evictions + b.total_evictions,
        total_writes=a.total_writes + b.total_writes)
