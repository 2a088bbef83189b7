"""Modeled work of each kernel entry: the fp32 operations and the bytes
its function needs, from its shapes, and the least time the card could
take for them (``bound``).

Bytes count each input read once and each output written once, whatever
the kernel reads again. Where the work depends on the data (the distinct
rings a query batch routes to, the distinct rows a bag reads, the
arrivals that evict), the caller passes what these inputs need; on
``meta`` there are no data, and that part is 0: the modeled work there is
the part that does not depend on the data, a lower bound.

``entry`` runs one kernel entry and, while an ``analysis.hlo_cost``
counter is active, records its modeled work as one op in place of the
aten ops its wrapper or plain version runs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.analysis import hlo_cost
from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS


class Work(NamedTuple):
    flops: float
    bytes: float


def bound(work: Work) -> tuple[float, str]:
    """(ms, "operations" | "bytes"): the larger of the fp32 operations
    over the H100's fp32 peak and the bytes over its HBM rate."""
    t_ops = work.flops / PEAK_FLOPS["float32"] * 1e3
    t_bytes = work.bytes / HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def entry(name: str, run: Callable[[], object], work: Callable[[object], Work]):
    """``run()``; with a cost counter active, ``work(out)`` recorded as
    one op named ``kernel.<name>`` and nothing ``run`` dispatches inside."""
    if not hlo_cost.ACTIVE:
        return run()
    with hlo_cost.muted():   # the work's own data reads are not counted either
        out = run()
        w = work(out)
    hlo_cost.record_entry(name, w.flops, w.bytes, out)
    return out


def distinct(ids: torch.Tensor) -> int:
    """The distinct non-negative values of ``ids`` (0 on ``meta``); a host
    read on a card, so only a counter calls it."""
    if ids.is_meta:
        return 0
    return int(torch.unique(ids[ids >= 0]).numel())


# ---------------------------------------------------------------------------
# One formula per entry
# ---------------------------------------------------------------------------
def admit(B: int, d: int, K: int, n: int, int8: bool, live: bool = True,
          emit_rows: bool = True) -> Work:
    """Screen against n basis rows, nearest of K centroids, the row out:
    x, basis and centroids read, the live mask read, r / keep / label /
    sim written (13 B a row), the int8 or fp32 row and its scale."""
    flops = 2.0 * B * d * (K + n) + 2.0 * K * d + 4.0 * B * d
    nbytes = 4 * (B * d + n * d + K * d) + B * live + B * 13
    if emit_rows:
        nbytes += B * d * (1 if int8 else 4) + 4 * B
    return Work(flops, nbytes)


def mips(Q: int, N: int, d: int, k: int) -> Work:
    """Q x N inner products: queries, rows and the valid mask read, the
    top-k scores and ids written."""
    return Work(2.0 * Q * N * d, 4 * (Q * d + N * d) + N + 8 * Q * k)


def serve(Q: int, d: int, cap: int, depth: int, nprobe: int, k: int, itemsize: int,
          int8: bool, rings: int = 0) -> Work:
    """Bytes: both query sets, the index (rows, valid, labels), each of
    the ``rings`` distinct routed rings once (rows, ids, int8 scales), the
    outputs (scores, pos, rows, doc ids, clusters; routes)."""
    ring = depth * (d * itemsize + 4 + (4 if int8 else 0))
    nbytes = 2 * Q * d * 4 + cap * (d * 4 + 5) + rings * ring + Q * (k * 20 + nprobe * 4)
    return Work(2.0 * Q * (cap + nprobe * depth) * d, nbytes)


def serve_route(Q: int, d: int, cap: int, nprobe: int) -> Work:
    """Bytes: the queries, the index (rows, valid, labels), the routes."""
    return Work(2.0 * Q * cap * d, 4 * Q * d + cap * (4 * d + 5) + 4 * Q * nprobe)


def rerank(Q: int, d: int, P: int, depth: int, k: int, itemsize: int, int8: bool,
           rings: int = 0) -> Work:
    """Bytes: queries, the [Q, P] routes, each of the ``rings`` distinct
    routed rings once (rows, ids, int8 scales), the outputs."""
    ring = depth * (d * itemsize + 4 + (4 if int8 else 0))
    nbytes = Q * d * 4 + Q * P * 4 + rings * ring + Q * k * 8
    return Work(2.0 * Q * P * depth * d, nbytes)


def prefilter(B: int, n: int, d: int) -> Work:
    return Work(2.0 * B * n * d + 3.0 * B * d, 4 * (B * d + n * d + B))


def assign(B: int, K: int, d: int) -> Work:
    return Work(2.0 * B * K * d + 3.0 * (B + K) * d, 4 * (B * d + K * d) + 8 * B)


def bag(L: int, d: int, bags: int, itemsize: int, rows: int = 0) -> Work:
    """Bytes: each of the ``rows`` distinct table rows once, 12 bytes an
    entry (index, segment, weight), the bags out in f32."""
    return Work(2.0 * L * d, rows * d * itemsize + L * 12 + bags * d * 4)


def heavy_hitter(B: int, bmax: int, cells: int, morris: bool, random_evict: bool,
                 evicting: int = 0) -> Work:
    """Bytes these inputs need: labels and draws in, the state (bmax slots,
    ``cells`` sketch counters, the scalars) in and out once, the info out,
    and for RANDOM_EVICT the Gumbel rows of the ``evicting`` arrivals that
    evict (no other arrival reads its row; 0 on ``meta``); no arithmetic
    worth a bound (integer compares). Both of the kernel's paths compute
    this one function: the large path's table, bitmap and group minima
    are its own scratch, not the function's bytes."""
    state = 8 * bmax + 4 * cells + 28
    draws = 4 * B * (1 + int(morris))
    if random_evict:
        draws += 4 * evicting * bmax
    return Work(0.0, 4 * B + draws + 2 * state + 10 * B)


def bag_backward(V: int, d: int, L: int, bags: int, itemsize: int, idx_bytes: int,
                 seg_bytes: int, weighted: bool, weights_grad: bool = False,
                 rows: int = 0) -> Work:
    """Bytes: the dense d_table written once, grad_out and each entry's
    (index, segment, weight) read once; with d_w, each of the ``rows``
    distinct rows read and d_w written."""
    nbytes = V * d * itemsize + bags * d * 4 + L * (idx_bytes + seg_bytes + 4 * weighted)
    if weights_grad:
        nbytes += rows * d * itemsize + L * 4
    return Work(3.0 * L * d, nbytes)


def gather_backward(V: int, d: int, L: int, itemsize: int, id_bytes: int) -> Work:
    """Bytes: the dense gradient written, grad_out (f32) and the ids read
    once."""
    return Work(float(L * d), V * d * itemsize + L * d * 4 + L * id_bytes)


def segment_sum(L: int, d: int, n: int, itemsize: int, id_bytes: int) -> Work:
    """Bytes: the entries read once, the dense result written once."""
    return Work(float(L * d), L * d * itemsize + n * d * itemsize + L * id_bytes)


def segment_order(L: int, n: int, id_bytes: int, nsplit: int) -> Work:
    """Bytes: the ids read once; the sorted ids and their positions, the
    n + 1 row offsets and the nsplit + 1 warp splits (row, entry) written
    once. A sort does no fp32 operation."""
    return Work(0.0, L * id_bytes + 8 * L + 4 * (n + 1) + 8 * (nsplit + 1))
