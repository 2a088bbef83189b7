"""Plain PyTorch version of the ``prefilter`` kernel's function: mean
cosine relevance ``r(x) = (1/n) Σ_i cos(x, v_i)``. The kernel itself is
still to be ported; on the ingest path the fused ``admit`` kernel scores
rows, and this is a piece of its plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import l2_normalize


def prefilter_scores_ref(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """x [B, d], basis [n, d] -> r [B] f32."""
    return torch.mean(l2_normalize(x) @ l2_normalize(basis).T, dim=1)
