"""Plain PyTorch version of the ``prefilter`` kernel: mean cosine
relevance ``r(x) = (1/n) Σ_i cos(x, v_i)``, in the reference oracle's
divide form (``l2_normalize`` of the rows and of the basis)."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import l2_normalize
from repro_torch.kernels.counts import COUNTS


def mean_cosine(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """The uncounted body, shared with the fused ``admit`` plain version
    (which counts its own calls)."""
    return torch.mean(l2_normalize(x) @ l2_normalize(basis).T, dim=1)


def prefilter_scores_ref(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """x [B, d], basis [n, d] -> r [B] f32."""
    COUNTS["prefilter"].plain += 1
    return mean_cosine(x, basis)
