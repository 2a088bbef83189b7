"""Plain PyTorch version of the ``assign`` kernel's function: nearest
centroid by cosine. The kernel itself is still to be ported; on the ingest
path the fused ``admit`` kernel assigns rows, and this is a piece of its
plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import l2_normalize


def assign_ref(x: torch.Tensor, centroids: torch.Tensor):
    """x [B, d], centroids [K, d] -> (best_id [B] i32, best_sim [B] f32);
    ties go to the lowest centroid index."""
    sims = l2_normalize(x) @ l2_normalize(centroids).T    # [B, K] fp32
    best_sim, best_id = torch.max(sims, dim=1)
    # torch.max promises no tie order: take the first index at the max
    first = torch.argmax((sims == best_sim[:, None]).to(torch.int32), dim=1)
    return first.to(torch.int32), best_sim
