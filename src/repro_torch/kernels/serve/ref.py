"""Plain PyTorch version of the fused serve path (the two-stage query in
one call): ``mips_topk_ref`` over the prototype index, the slot -> cluster
route-label map, then ``rerank.ref.routed_topk`` over the routed ring
buffers, as the reference's ``kernels/serve/ref.py`` composes them."""
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
    sc1, slots = mips_topk_ref(qr, vectors, valid, nprobe)
    labels = route_labels[slots.to(torch.int64)]
    routes = torch.where((sc1 > NEG_INF / 2) & (labels >= 0), labels, -1)
    scores, pos = routed_topk(qn, embs, live, routes, k, scales)
    return scores, pos, routes.to(torch.int32)
