"""Plain PyTorch version of the fused serve path (the two-stage query in
one call): ``mips_topk_ref`` over the prototype index, the slot -> cluster
route-label map, then ``rerank.ref.routed_topk`` over the routed ring
buffers, as the reference's ``kernels/serve/ref.py`` composes them; and
that first stage alone (``serve_routes_ref``), the route-only entry's
plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.counts import COUNTS
from repro_torch.kernels.mips.ref import mips_topk_ref
from repro_torch.kernels.rerank.ref import routed_topk


def serve_topk_ref(qr: torch.Tensor, qn: torch.Tensor, vectors: torch.Tensor,
                   valid: torch.Tensor, route_labels: torch.Tensor,
                   embs: torch.Tensor, live: torch.Tensor, k: int,
                   nprobe: int, scales: torch.Tensor | None = None):
    """qr/qn [Q, d] stage-1/stage-2 query vectors; vectors [cap, d] +
    valid [cap] the prototype index; route_labels [cap] i32 (-1 dead);
    embs [C, depth, d] (f32, or int8 with ``scales`` [C, depth]); live
    [C, depth] bool. Returns (scores [Q, k] desc, pos [Q, k] i32 =
    j * depth + slot, routes [Q, nprobe] i32; -1 for dead entries)."""
    COUNTS["serve"].plain += 1
    routes = _routes(qr, vectors, valid, route_labels, nprobe)
    scores, pos = routed_topk(qn, embs, live, routes, k, scales)
    return scores, pos, routes


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
