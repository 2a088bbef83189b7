"""Dispatcher for the mean-cosine screen: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_same_device
from repro_torch.kernels.prefilter.ref import prefilter_scores_ref


def prefilter_scores(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Mean-cosine relevance r(x) of each row against the topic basis:
    [B] f32."""
    if check_same_device(x, basis).type == "cuda":
        from repro_torch.kernels.prefilter.prefilter import prefilter_scores_cuda

        return prefilter_scores_cuda(x, basis)
    return prefilter_scores_ref(x, basis)


def prefilter(x: torch.Tensor, basis: torch.Tensor, alpha: float):
    """Returns (r [B] f32, keep [B] bool) with keep = r >= alpha."""
    r = prefilter_scores(x, basis)
    return r, r >= alpha
