"""Plain PyTorch version of the fused serve path (the two-stage query in
one call): ``mips_topk_ref`` over the prototype index, the slot -> cluster
route-label map, then ``rerank.ref.routed_topk`` over the routed ring
buffers, as the reference's ``kernels/serve/ref.py`` composes them, and
the decode of the picks (``decode_pos``, ``stages.decode_rerank``'s math);
and that first stage alone (``serve_routes_ref``), the route-only entry's
plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.counts import COUNTS
from repro_torch.kernels.mips.ref import mips_topk_ref
from repro_torch.kernels.rerank.ref import routed_topk


def serve_topk_ref(qr: torch.Tensor, qn: torch.Tensor, vectors: torch.Tensor,
                   valid: torch.Tensor, route_labels: torch.Tensor,
                   embs: torch.Tensor, ids: torch.Tensor, k: int,
                   nprobe: int, scales: torch.Tensor | None = None,
                   store_depth: int | None = None):
    """qr/qn [Q, d] stage-1/stage-2 query vectors; vectors [cap, d] +
    valid [cap] the prototype index; route_labels [cap] i32 (-1 dead);
    embs [C, depth, d] (f32, or int8 with ``scales`` [C, depth]); ids
    [C, depth] i32 document ids, a slot live where >= 0. Returns (scores
    [Q, k] desc, pos [Q, k] i32 = j * depth + slot, routes [Q, nprobe]
    i32, then ``decode_pos``'s rows, doc_ids and clusters [Q, k] i32; -1
    for dead entries)."""
    COUNTS["serve"].plain += 1
    routes = _routes(qr, vectors, valid, route_labels, nprobe)
    scores, pos = routed_topk(qn, embs, ids, routes, k, scales)
    return (scores, pos, routes) + decode_pos(ids, routes, pos, embs.shape[1], nprobe,
                                              store_depth)


def decode_pos(ids, routes, pos, depth: int, nprobe: int,
               store_depth: int | None = None, doc_ids=None):
    """Resolve rerank positions ``pos`` = j * depth + slot into (rows,
    doc_ids, clusters) i32: cluster = routes[j], doc id = ids[cluster,
    slot], row = cluster * store_depth + slot (``store_depth`` defaults
    to ``depth``), -1 where dead. ``doc_ids`` may come resolved (the
    sharded rerank reads them on the shard that holds the ring); otherwise
    they are read from ``ids``. The serve kernel's epilogue computes the
    same integers."""
    if store_depth is None:
        store_depth = depth
    dead = pos < 0
    p = pos.to(torch.int64)
    j = torch.clamp(torch.div(p, depth, rounding_mode="floor"), 0, nprobe - 1)
    slot = torch.clamp(torch.remainder(p, depth), 0, depth - 1)
    cluster = torch.gather(routes.to(torch.int64), 1, j)
    cluster = torch.where(dead, -1, cluster)
    cc = torch.clamp(cluster, min=0)
    if doc_ids is None:
        doc_ids = torch.where(dead, -1, ids[cc, slot])
    rows = torch.where(dead, -1, cc * store_depth + slot)
    return rows.to(torch.int32), doc_ids.to(torch.int32), cluster.to(torch.int32)


def _routes(qr, vectors, valid, route_labels, nprobe):
    sc1, slots = mips_topk_ref(qr, vectors, valid, nprobe)
    labels = route_labels[slots.to(torch.int64)]
    return torch.where((sc1 > NEG_INF / 2) & (labels >= 0), labels,
                       -1).to(torch.int32)


def serve_routes_ref(qr: torch.Tensor, vectors: torch.Tensor,
                     valid: torch.Tensor, route_labels: torch.Tensor,
                     nprobe: int) -> torch.Tensor:
    """Stage 1 of ``serve_topk_ref`` alone: routes [Q, nprobe] i32, the
    top-``nprobe`` prototype slots mapped through ``route_labels`` (-1
    where the slot's score or label is dead)."""
    COUNTS["serve_route"].plain += 1
    return _routes(qr, vectors, valid, route_labels, nprobe)
