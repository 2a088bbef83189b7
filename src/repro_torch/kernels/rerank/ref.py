"""Plain PyTorch version of the ``rerank`` kernel: exact top-k over each
query's routed ring buffers."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF, stable_topk
from repro_torch.kernels.counts import COUNTS


def rerank_topk_ref(q: torch.Tensor, embs: torch.Tensor, live: torch.Tensor,
                    routes: torch.Tensor, k: int,
                    scales: torch.Tensor | None = None):
    """See ``routed_topk``."""
    COUNTS["rerank"].plain += 1
    return routed_topk(q, embs, live, routes, k, scales)


def routed_topk(q: torch.Tensor, embs: torch.Tensor, live: torch.Tensor,
                routes: torch.Tensor, k: int,
                scales: torch.Tensor | None = None):
    """The uncounted body, shared with the fused ``serve`` plain version
    (which counts its own calls).

    q [Q, d] unit queries; embs [C, depth, d] (f32, or int8 with
    ``scales`` [C, depth]); live [C, depth] bool; routes [Q, P] i32 (-1 =
    no route). Scores are ``(q · e) * scale`` in fp32. Returns (scores
    [Q, k] desc with NEG_INF for dead entries, pos [Q, k] i32 =
    j * depth + slot, -1 where dead); ties to the lowest position."""
    Q = q.shape[0]
    C = embs.shape[0]
    r = torch.clamp(routes, 0, C - 1).to(torch.int64)
    cand = embs[r]                                        # [Q, P, depth, d]
    s = torch.einsum("qd,qpsd->qps", q.to(torch.float32),
                     cand.to(torch.float32))
    if scales is not None:
        s = s * scales[r].to(torch.float32)
    ok = live[r] & (routes >= 0)[..., None]
    s = torch.where(ok, s, NEG_INF).reshape(Q, -1)        # [Q, P*depth]
    scores, pos = stable_topk(s, k)
    pos = torch.where(scores > NEG_INF / 2, pos, -1)
    return scores, pos.to(torch.int32)
