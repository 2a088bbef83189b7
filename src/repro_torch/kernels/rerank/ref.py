"""Plain PyTorch version of the ``rerank`` kernel: exact top-k over each
query's routed ring buffers."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF, rowwise_dots, stable_topk
from repro_torch.kernels.counts import COUNTS


def rerank_topk_ref(q: torch.Tensor, embs: torch.Tensor, ids: torch.Tensor,
                    routes: torch.Tensor, k: int,
                    scales: torch.Tensor | None = None):
    """See ``routed_topk``."""
    COUNTS["rerank"].plain += 1
    return routed_topk(q, embs, ids, routes, k, scales)


def routed_topk(q: torch.Tensor, embs: torch.Tensor, ids: torch.Tensor,
                routes: torch.Tensor, k: int,
                scales: torch.Tensor | None = None):
    """The uncounted body, shared with the fused ``serve`` plain version
    (which counts its own calls).

    q [Q, d] unit queries; embs [C, depth, d] (f32, or int8 with
    ``scales`` [C, depth]); ids [C, depth] i32 document ids (a slot is
    live where its id is >= 0); routes [Q, P] i32 (-1 =
    no route). Scores are ``(q · e) * scale`` in fp32. Returns (scores
    [Q, k] desc with NEG_INF for dead entries, pos [Q, k] i32 =
    j * depth + slot, -1 where dead); ties to the lowest position."""
    Q, P = routes.shape
    C, depth, d = embs.shape
    r = torch.clamp(routes, 0, C - 1).to(torch.int64)
    cand = embs[r].reshape(Q, P * depth, d)
    s = rowwise_dots(q, cand).reshape(Q, P, depth)
    if scales is not None:
        s = s * scales[r].to(torch.float32)
    ok = (ids[r] >= 0) & (routes >= 0)[..., None]
    s = torch.where(ok, s, NEG_INF).reshape(Q, P * depth)
    scores, pos = stable_topk(s, k)
    pos = torch.where(scores > NEG_INF / 2, pos, -1)
    return scores, pos.to(torch.int32)
