"""Dispatcher for the mean-cosine screen: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel, a ``meta`` tensor gets the
output's shape and dtype, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.common import check_same_device
from repro_torch.kernels.prefilter.ref import prefilter_scores_ref


def prefilter_scores(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Mean-cosine relevance r(x) of each row against the topic basis:
    [B] f32."""
    dev = check_same_device(x, basis)

    def run():
        if dev.type == "cuda":
            from repro_torch.kernels.prefilter.prefilter import prefilter_scores_cuda

            return prefilter_scores_cuda(x, basis)
        if dev.type == "meta":
            return torch.empty((x.shape[0],), dtype=torch.float32, device=dev)
        return prefilter_scores_ref(x, basis)

    return cost.entry("prefilter", run, lambda out: cost.prefilter(
        x.shape[0], basis.shape[0], x.shape[1]))


def prefilter(x: torch.Tensor, basis: torch.Tensor, alpha: float):
    """Returns (r [B] f32, keep [B] bool) with keep = r >= alpha."""
    r = prefilter_scores(x, basis)
    return r, r >= alpha
