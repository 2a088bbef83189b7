"""Plain PyTorch version of the ``assign`` kernel: nearest centroid by
cosine, in the reference oracle's divide form."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import l2_normalize
from repro_torch.kernels.counts import COUNTS


def nearest_centroid(x: torch.Tensor, centroids: torch.Tensor):
    """The uncounted body, shared with the fused ``admit`` plain version
    (which counts its own calls)."""
    sims = l2_normalize(x) @ l2_normalize(centroids).T    # [B, K] fp32
    best_sim, _ = torch.max(sims, dim=1)
    # torch.max promises no tie order: take the first index at the max
    first = torch.argmax((sims == best_sim[:, None]).to(torch.int32), dim=1)
    return first.to(torch.int32), best_sim


def assign_ref(x: torch.Tensor, centroids: torch.Tensor):
    """x [B, d], centroids [K, d] -> (best_id [B] i32, best_sim [B] f32);
    ties go to the lowest centroid index."""
    COUNTS["assign"].plain += 1
    return nearest_centroid(x, centroids)
