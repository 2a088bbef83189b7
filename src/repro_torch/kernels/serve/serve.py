"""ctypes wrapper of the hand-written CUDA ``serve`` kernel
(``repro_torch/csrc/serve.cu``): the two-stage query in two launches,
route tiles then the routed rerank (with merge passes between them where
a query has more route keys than its selection ranks); and its
route-only entry (the route tiles and passes, then the fused kernel's
route selection), which the serving cache's route witness launches.

The ring tensors may be strided views (``embs[:, :depth]`` for a
depth-clipped plan): their strides go to the kernel, and the store is
never copied. A slot is live where its document id is >= 0: the kernel
reads the ring ids, and its epilogue decodes the answer (rows, doc ids,
clusters), so a call is the whole two-stage query. ``serve_plan`` sizes a
call from its shape alone, and it and the call's shared-memory size are
cached by shape (``serve_plan.cache_info()`` counts the hits)."""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import SMS, cdiv
from repro_torch.kernels.counts import COUNTS
from repro_torch.kernels.rerank.rerank import RING_WARPS, ring_cluster, ring_smem_bytes, warp_keep

ROUTE_TILE_COLS = 64       # serve.cu's kTileCols: prototypes per route tile
ROUTE_TILE_RMS = (8, 4, 2)  # route tile rows / 8, largest first
MERGE_WAYS = 32            # serve.cu's kMergeWays: sorted key lists a pass's warp merges
# keys.cuh's key carries a slot as 32 bits and the kernels index slots and
# a query's keys in int: the largest cap whose last route tile still does
MAX_CAP = 2**31 - ROUTE_TILE_COLS
# the most route keys a query's selection ranks (128 KB): past it a merge
# pass, which costs less than ranking the keys it removes, comes first
SELECT_KEYS = 16_384


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """How one call runs: route tiles of ``8 * rm`` queries x 64
    prototypes (``ntiles`` column tiles, each keeping its ``kt`` largest
    keys per query in order, ``m`` route keys per query in all), then,
    where a query has more keys than its selection ranks, merge passes
    that merge every ``MERGE_WAYS`` such lists into one list of the
    nprobe largest (``levels``: the keys a query has after each pass), then
    the rerank as ``cluster`` blocks per query."""

    rm: int
    ntiles: int
    kt: int
    m: int
    cluster: int
    levels: tuple[int, ...] = ()

    @property
    def msel(self) -> int:
        """The keys a query's selection ranks."""
        return self.levels[-1] if self.levels else self.m


def select_bytes(n: int, nprobe: int) -> int:
    """A selection's share of its block (rings.cuh, serve.cu): ``n`` route
    keys and the warps' lists of them."""
    return 8 * (n + RING_WARPS * warp_keep(n, nprobe))


@functools.lru_cache(maxsize=4096)
def serve_plan(Q: int, cap: int, nprobe: int, depth: int, d: int | None = None,
               k: int | None = None) -> ServePlan:
    """The largest route tile whose grid still covers the card's SMs (the
    smallest where none does), the rerank's cluster size, and the
    merge passes the selection needs. Both entries follow one rule: a pass
    merges every ``MERGE_WAYS`` lists into one of nprobe keys while a
    query has more than ``SELECT_KEYS`` keys, or more than its selection's
    block holds beside what else the block keeps: the fused call's ring
    layout, sized from ``d`` and ``k`` where they are given (at d 384 and
    depth 64 it leaves room for ``SELECT_KEYS``, so both entries run the
    same passes). Refuses a cap past 32-bit slot arithmetic
    (``MAX_CAP``) and a ring layout or nprobe that no number of passes
    brings into one block. Cached by its arguments: a flush's shape
    repeats, so the host plans it once."""
    if not 1 <= nprobe <= cap:
        raise ValueError(f"need 1 <= nprobe={nprobe} <= cap={cap}")
    if cap > MAX_CAP:
        raise ValueError(f"serve's route keys carry 32-bit slots (keys.cuh): cap {cap} "
                         f"is past {MAX_CAP}")
    ntiles = cdiv(cap, ROUTE_TILE_COLS)
    kt = min(nprobe, ROUTE_TILE_COLS)
    rm = next((r for r in ROUTE_TILE_RMS if ntiles * cdiv(Q, 8 * r) >= SMS),
              ROUTE_TILE_RMS[-1])
    cluster = ring_cluster(Q, nprobe * depth)
    base = 0 if d is None else ring_smem_bytes(d, nprobe, depth, k, cluster)
    if base > build.SMEM_PER_BLOCK:
        raise ValueError(f"serve's rerank needs {base} B of shared memory before any "
                         f"route key (d={d}, nprobe={nprobe}, depth={depth}, k={k}), "
                         f"over the {build.SMEM_PER_BLOCK} B a block has")

    def fits(n):
        return n <= SELECT_KEYS and base + select_bytes(n, nprobe) <= build.SMEM_PER_BLOCK
    levels, lists, length = [], ntiles, kt
    while not fits(lists * length):
        merged = cdiv(lists, MERGE_WAYS)
        if merged * nprobe >= lists * length:
            if base + select_bytes(lists * length, nprobe) <= build.SMEM_PER_BLOCK:
                break                     # nprobe past SELECT_KEYS: its keys alone
            raise ValueError(f"nprobe={nprobe} route keys do not fit one block's "
                             f"{build.SMEM_PER_BLOCK} B of shared memory")
        lists, length = merged, nprobe
        levels.append(lists * length)
    return ServePlan(rm, ntiles, kt, ntiles * kt, cluster, tuple(levels))


@functools.lru_cache(maxsize=None)
def _card_bytes(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).total_memory


def _key_buffers(plan: ServePlan, Q: int, dev) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The route keys [Q, m] and, where the plan has passes, the second
    buffer they alternate with [Q, the first pass's keys] (int64, one
    allocation). Refuses a call whose keys the card cannot hold."""
    m2 = plan.levels[0] if plan.levels else 0
    words = Q * (plan.m + m2)
    if dev.type == "cuda" and 8 * words > _card_bytes(dev):
        raise ValueError(f"serve's route keys need {8 * words} B (Q={Q}, {plan.m} keys a "
                         f"query), more than the card's memory")
    keys = torch.empty((words,), dtype=torch.int64, device=dev)
    part = keys[:Q * plan.m].view(Q, plan.m)
    return part, (keys[Q * plan.m:].view(Q, m2) if plan.levels else None)


def serve_outputs(Q: int, k: int, nprobe: int, dev) -> tuple[torch.Tensor, ...]:
    """The call's outputs as views of one int32 block, each contiguous:
    (scores [Q, k] f32, pos, routes [Q, nprobe], rows, doc_ids, clusters
    [Q, k] i32)."""
    block = torch.empty((Q * (5 * k + nprobe),), dtype=torch.int32, device=dev)
    planes, routes = block.split((5 * Q * k, Q * nprobe))
    scores, pos, rows, doc_ids, clusters = planes.view(5, Q, k).unbind(0)
    return scores.view(torch.float32), pos, routes.view(Q, nprobe), rows, doc_ids, clusters


def _lib():
    lib = build.load("serve")
    if lib.serve_launch.argtypes is None:
        P, I, L = build.P, build.I, build.L
        lib.serve_launch.argtypes = [P, P, I, I, P, I, P, P, P, I, L, L, P, L, L, P, L, L,
                                     I, I, I, I, I, I, I, P, P, P, P, P, P, P, P, I, P]
        lib.serve_launch.restype = I
        lib.serve_smem_bytes.argtypes = [I, I, I, I, I, I]
        lib.serve_smem_bytes.restype = L
        lib.serve_route_cols.restype = I
        lib.serve_route_launch.argtypes = [P, I, I, P, I, P, P, I, I, I, P, P, P, P]
        lib.serve_route_launch.restype = I
        lib.serve_route_smem_bytes.argtypes = [I, I]
        lib.serve_route_smem_bytes.restype = L
        lib.serve_merge_ways.restype = I
        if (lib.serve_route_cols(), lib.serve_merge_ways()) != (ROUTE_TILE_COLS, MERGE_WAYS):
            raise RuntimeError("serve.cu's route tile width or merge ways differ from the "
                               "wrapper's")
    return lib


@functools.lru_cache(maxsize=4096)
def _fused_smem(d: int, msel: int, nprobe: int, depth: int, k: int, cluster: int) -> int:
    """The fused call's shared memory a block, checked against the
    library's own figure and the block's limit; cached by its arguments."""
    smem = _lib().serve_smem_bytes(d, msel, nprobe, depth, k, cluster)
    if smem != ring_smem_bytes(d, nprobe, depth, k, cluster, msel):
        raise RuntimeError("rings.cuh's shared-memory layout differs from the wrapper's")
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"serve kernel needs {smem} B of shared memory "
                         f"(d={d}, nprobe={nprobe}, depth={depth}, k={k}, "
                         f"{msel} route keys), over the {build.SMEM_PER_BLOCK} B a "
                         f"block has")
    return smem


def serve_launcher(qr: torch.Tensor, qn: torch.Tensor, vectors: torch.Tensor,
                   valid: torch.Tensor, route_labels: torch.Tensor,
                   embs: torch.Tensor, ids: torch.Tensor, k: int, nprobe: int,
                   scales: torch.Tensor | None = None, plan: ServePlan | None = None,
                   store_depth: int | None = None):
    """Checks, plans (``serve_plan`` unless ``plan`` is given: the card's
    tests pass one to hold every plan against the plain version) and
    allocates one call; returns (plan, outputs, run): the outputs are
    ``serve_outputs``'s views, and ``run(phases)`` queues the launches
    (1 = route tiles, 4 = the merge passes, where the plan has any, 2 =
    rerank and decode, 7 = all) on the current stream without counting
    them. The wrapper runs all; a timing script may run them apart, once a
    run has written the keys they read: ``run`` refuses the merge where the
    route tiles' keys are not in their buffer (none yet, or a second pass
    wrote over them), and the rerank before the tiles and, where the plan
    has passes, the merge have run."""
    Q, d = qr.shape
    cap = vectors.shape[0]
    C, depth, _ = embs.shape
    quantized = embs.dtype == torch.int8
    if (scales is not None) != quantized:
        raise ValueError("int8 rings need per-slot scales; fp32 rings none")
    if not quantized and embs.dtype != torch.float32:
        raise TypeError(f"ring dtype {embs.dtype}: fp32 or int8")
    if not 1 <= k <= nprobe * depth or not 1 <= nprobe <= cap:
        raise ValueError("need 1 <= k <= nprobe*depth and nprobe <= cap")
    if embs.shape[2] != d or embs.stride(2) != 1:
        raise ValueError("ring rows must be dense along d")
    if ids.dtype != torch.int32 or ids.shape != (C, depth):
        raise TypeError("ids must be a [C, depth] int32 tensor")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.shape != (C, depth)):
        raise TypeError("scales must be a [C, depth] float32 tensor")
    for t in (qr, qn, vectors, valid, route_labels):
        if not t.is_contiguous():
            raise ValueError("queries and index must be contiguous")
    if route_labels.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("route_labels i32 and valid bool")
    store_depth = depth if store_depth is None else store_depth
    if store_depth < depth:
        raise ValueError(f"store_depth {store_depth} is below the rings' depth {depth}")
    dev = qr.device
    plan = plan or serve_plan(Q, cap, nprobe, depth, d, k)
    out = serve_outputs(Q, k, nprobe, dev)
    if Q == 0:
        return plan, out, lambda phases=7: None
    lib = _lib()
    smem = _fused_smem(d, plan.msel, nprobe, depth, k, plan.cluster)
    part, part2 = _key_buffers(plan, Q, dev)
    ss0, ss1 = (scales.stride(0), scales.stride(1)) if quantized else (0, 0)
    stream = build.stream_of(dev)
    ptrs = [t.data_ptr() for t in out]

    # what the key buffers hold: the route tiles' keys (a second pass writes
    # over them) and the last pass's
    tiled = merged = False

    def run(phases=7):
        nonlocal tiled, merged
        merge = bool(phases & 4 and plan.levels)
        tiles_ok = bool(phases & 1) or tiled
        sel_ok = (merge or (merged and not phases & 1)) if plan.levels else tiles_ok
        if (merge and not tiles_ok) or (phases & 2 and not sel_ok):
            raise RuntimeError(f"serve phases {phases} read keys that no earlier phase has "
                               f"written to this call's buffers: run phase 1 (then 4) first")
        build.check(lib, lib.serve_launch(
            qr.data_ptr(), qn.data_ptr(), Q, d, vectors.data_ptr(), cap,
            valid.data_ptr(), route_labels.data_ptr(), embs.data_ptr(), depth,
            embs.stride(0), embs.stride(1), ids.data_ptr(), ids.stride(0),
            ids.stride(1), build.ptr(scales), ss0, ss1, int(quantized), store_depth, k,
            nprobe, plan.rm, plan.cluster, plan.msel, part.data_ptr(), build.ptr(part2),
            *ptrs, phases, stream), "serve_launch")
        if phases & 1:
            tiled, merged = True, False
        if merge:
            tiled, merged = tiles_ok and len(plan.levels) == 1, True
    return plan, out, run


def serve_topk_cuda(qr: torch.Tensor, qn: torch.Tensor, vectors: torch.Tensor,
                    valid: torch.Tensor, route_labels: torch.Tensor,
                    embs: torch.Tensor, ids: torch.Tensor, k: int,
                    nprobe: int, scales: torch.Tensor | None = None,
                    store_depth: int | None = None):
    """Same contract as ``ref.serve_topk_ref``; all tensors on one CUDA
    device. embs [C, depth, d] / ids / scales [C, depth] may be strided
    along their leading axes; their last axis must be dense. The six
    outputs are views of one block (``serve_outputs``)."""
    _, out, run = serve_launcher(qr, qn, vectors, valid, route_labels, embs, ids, k,
                                 nprobe, scales, store_depth=store_depth)
    if qr.shape[0] == 0:
        return out
    run()
    COUNTS["serve"].kernel += 1
    return out


def serve_routes_cuda(qr: torch.Tensor, vectors: torch.Tensor, valid: torch.Tensor,
                      route_labels: torch.Tensor, nprobe: int) -> torch.Tensor:
    """Same contract as ``ref.serve_routes_ref``; all tensors on one CUDA
    device: the routes ``serve_topk_cuda`` serves through, bit for bit.
    The route tiles are the fused call's whatever the plan (every dot is
    one sum over d in order); the merge passes, where its plan has any,
    keep the top-nprobe of the same unique keys; then the fused call's
    selection ranks them."""
    Q, d = qr.shape
    cap = vectors.shape[0]
    if not 1 <= nprobe <= cap:
        raise ValueError(f"need 1 <= nprobe={nprobe} <= cap={cap}")
    if vectors.shape[1] != d:
        raise ValueError("queries and index must share d")
    for t in (qr, vectors, valid, route_labels):
        if not t.is_contiguous():
            raise ValueError("queries and index must be contiguous")
    if route_labels.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("route_labels i32 and valid bool")
    dev = qr.device
    routes = torch.empty((Q, nprobe), dtype=torch.int32, device=dev)
    if Q == 0:
        return routes
    plan = serve_plan(Q, cap, nprobe, 1)
    lib = _lib()
    if lib.serve_route_smem_bytes(plan.msel, nprobe) != select_bytes(plan.msel, nprobe):
        raise RuntimeError("serve.cu's selection layout differs from the wrapper's")
    part, part2 = _key_buffers(plan, Q, dev)
    build.check(lib, lib.serve_route_launch(
        qr.data_ptr(), Q, d, vectors.data_ptr(), cap, valid.data_ptr(),
        route_labels.data_ptr(), nprobe, plan.rm, plan.msel, part.data_ptr(),
        build.ptr(part2), routes.data_ptr(), build.stream_of(dev)), "serve_route_launch")
    COUNTS["serve_route"].kernel += 1
    return routes
