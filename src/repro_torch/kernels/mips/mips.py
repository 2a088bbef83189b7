"""ctypes wrapper of the hand-written CUDA ``mips`` kernel
(``repro_torch/csrc/mips.cu``): top-k inner products for any N.

``mips_plan`` picks the kernel's path from the shape alone: the blocked
path (register-blocked tiles of up to 64 queries x 32 rows with a
per-tile bitonic top-k) for a small index and a small k, the threshold
path (per-block exact threshold search on composite keys) for everything
else, above all k = 100 over 10^6 item rows. Both merge with the same
pruned block merge."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import SMS, cdiv, round_up
from repro_torch.kernels.counts import COUNTS

# The blocked path keeps k keys of each tile's 32 rows (so k <= 32) and
# merges ceil(N / 32) * k keys a query: in registers up to MERGE_CAP.
BLOCKED_MAX_K = 32
BLOCKED_MAX_ROWS = 65_536
TILE_ROWS = 32             # mips.cu's kTileRows
# mips.cu's constants (kSelectThreads, kSelectSlots, kMergeCap,
# kMaxThresholdK)
SELECT_THREADS = 1024
SELECT_SLOTS = 8           # keys a select thread holds: bn <= 8192
MERGE_CAP = 16_384         # keys a merge block holds in registers (more: spill)
RANK_CAP = 2048            # candidates a block ranks (keys.cuh's kRankCap)
THRESHOLD_MAX_K = 8192
SELECT_SMEM = 160 * 1024   # score bytes a select block may hold


@dataclasses.dataclass(frozen=True)
class MipsPlan:
    """How one call runs: ``qb`` queries per select block (threshold path:
    1, 2, 4 or 8; blocked path: a tile of 16, 32 or 64), ``bn`` rows per
    block (blocked: TILE_ROWS), ``nblk`` row blocks (each keeps k keys per
    query for the merge), ``P`` the merge's sort width (a power of two >=
    k)."""

    path: str
    qb: int = 0
    bn: int = 0
    nblk: int = 0
    P: int = 0


def mips_plan(Q: int, N: int, k: int) -> MipsPlan:
    """The path and sizes of a call at this shape (pure shape arithmetic,
    the same on every device)."""
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must be in [1, N={N}]")
    P = 1 << (k - 1).bit_length()
    if k <= BLOCKED_MAX_K and N <= BLOCKED_MAX_ROWS:
        qb = next(b for b in (16, 32, 64) if b >= min(Q, 64))
        return MipsPlan("blocked", qb, TILE_ROWS, cdiv(N, TILE_ROWS), P)
    if k > THRESHOLD_MAX_K:
        raise ValueError(f"mips kernel takes k <= {THRESHOLD_MAX_K} (k={k})")
    qb = next(b for b in (1, 2, 4, 8) if b >= min(Q, 8))
    groups = cdiv(Q, qb)
    # one wave: about one select block per SM, at least k rows a block
    bn = round_up(max(cdiv(N * groups, SMS), k), SELECT_THREADS)
    cap = min(SELECT_SMEM // (4 * qb) // SELECT_THREADS * SELECT_THREADS,
              SELECT_THREADS * SELECT_SLOTS)
    if bn > cap:
        if k > cap:
            raise ValueError(f"mips kernel takes k <= {cap} at {Q} queries (k={k})")
        bn = cap
    return MipsPlan("threshold", qb, bn, cdiv(N, bn), P)


def spill_shape(plan: MipsPlan, Q: int, k: int) -> tuple[int, int]:
    """The merge's device-memory survivor list: [Q, nblk * k] keys where a
    query's nblk * k keys exceed what a merge block holds in registers,
    else a single unused key."""
    m = plan.nblk * k
    return (Q, m) if m > MERGE_CAP else (1, 1)


def select_smem_bytes(plan: MipsPlan, d: int) -> int:
    """Dynamic shared memory of a threshold-path select block (the
    blocked path's tiles take a fixed amount, ``tile_smem_bytes`` in
    mips.cu)."""
    return 8 * RANK_CAP + 4 * plan.qb * (d + plan.bn)


def _lib():
    lib = build.load("mips")
    if lib.mips_launch.argtypes is None:
        P, I = build.P, build.I
        lib.mips_launch.argtypes = [P, I, I, P, I, P, I, I, I, P, P, P, P, P, I, P]
        lib.mips_launch.restype = I
        lib.mips_threshold_launch.argtypes = [P, I, I, P, I, P, I, I, I, I, P, P, P,
                                              P, P, I, P]
        lib.mips_threshold_launch.restype = I
        names = ("mips_select_threads", "mips_select_slots", "mips_merge_cap",
                 "mips_threshold_max_k", "mips_tile_rows")
        for name in names:
            getattr(lib, name).restype = I
        have = tuple(getattr(lib, name)() for name in names)
        if have != (SELECT_THREADS, SELECT_SLOTS, MERGE_CAP, THRESHOLD_MAX_K, TILE_ROWS):
            raise RuntimeError(f"mips.cu's constants {have} differ from the wrapper's")
    return lib


def _check(q, index, valid):
    Q, d = q.shape
    N = index.shape[0]
    if q.dtype != torch.float32 or index.dtype != torch.float32:
        raise TypeError("mips kernel takes float32 queries and index")
    if valid.dtype != torch.bool or valid.shape != (N,):
        raise TypeError("valid must be a [N] bool tensor")
    if index.shape[1] != d or not (q.is_contiguous() and index.is_contiguous()
                                   and valid.is_contiguous()):
        raise ValueError("mips kernel takes contiguous [Q, d] and [N, d]")
    return Q, N, d


def mips_launcher(q: torch.Tensor, index: torch.Tensor, valid: torch.Tensor, k: int):
    """Checks, plans and allocates one call; returns (plan, scores, ids,
    run) where ``run(phases)`` queues the launches (1 = select, 2 =
    merge, 3 = both) on the current stream without counting them. The
    wrapper runs both; a timing script may run them apart."""
    Q, N, d = _check(q, index, valid)
    dev = q.device
    plan = mips_plan(Q, N, k)
    scores = torch.empty((Q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return plan, scores, ids, lambda phases=3: None
    if plan.path == "threshold" and select_smem_bytes(plan, d) > build.SMEM_PER_BLOCK:
        raise ValueError(f"mips kernel: d={d} leaves no shared memory for "
                         f"{plan.qb} queries")
    lib = _lib()
    stream = build.stream_of(dev)
    part_keys = torch.empty((Q, plan.nblk * k), dtype=torch.int64, device=dev)
    part_t = torch.empty((Q, plan.nblk), dtype=torch.int64, device=dev)
    spill = torch.empty(spill_shape(plan, Q, k), dtype=torch.int64, device=dev)
    if plan.path == "blocked":
        def run(phases=3):
            build.check(lib, lib.mips_launch(
                q.data_ptr(), Q, d, index.data_ptr(), N, valid.data_ptr(), k, plan.qb // 16,
                plan.P, part_keys.data_ptr(), part_t.data_ptr(), spill.data_ptr(),
                scores.data_ptr(), ids.data_ptr(), phases, stream), "mips_launch")
        return plan, scores, ids, run

    def run(phases=3):
        build.check(lib, lib.mips_threshold_launch(
            q.data_ptr(), Q, d, index.data_ptr(), N, valid.data_ptr(), k, plan.qb,
            plan.bn, plan.P, part_keys.data_ptr(), part_t.data_ptr(),
            spill.data_ptr(), scores.data_ptr(), ids.data_ptr(), phases, stream),
            "mips_threshold_launch")
    return plan, scores, ids, run


def mips_topk_cuda(q: torch.Tensor, index: torch.Tensor, valid: torch.Tensor,
                   k: int):
    """q [Q, d] f32, index [N, d] f32, valid [N] bool, all contiguous on
    one CUDA device -> (scores [Q, k] f32, ids [Q, k] i32)."""
    _, scores, ids, run = mips_launcher(q, index, valid, k)
    if q.shape[0] == 0:
        return scores, ids
    run()
    COUNTS["mips"].kernel += 1
    return scores, ids
