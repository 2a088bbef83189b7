"""Dispatcher for nearest-centroid assignment: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel, a ``meta`` tensor gets
the outputs' shapes and dtypes, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.assign.ref import assign_ref
from repro_torch.kernels.common import check_same_device


def assign(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest centroid by cosine: (best_id [B] i32, best_sim [B] f32),
    ties to the lowest centroid index."""
    dev = check_same_device(x, centroids)

    def run():
        if dev.type == "cuda":
            from repro_torch.kernels.assign.assign import assign_cuda

            return assign_cuda(x, centroids)
        if dev.type == "meta":
            B = x.shape[0]
            return (torch.empty((B,), dtype=torch.int32, device=dev),
                    torch.empty((B,), dtype=torch.float32, device=dev))
        return assign_ref(x, centroids)

    return cost.entry("assign", run, lambda out: cost.assign(
        x.shape[0], centroids.shape[0], x.shape[1]))
