"""Dispatcher for nearest-centroid assignment: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.assign.ref import assign_ref
from repro_torch.kernels.common import check_same_device


def assign(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest centroid by cosine: (best_id [B] i32, best_sim [B] f32),
    ties to the lowest centroid index."""
    if check_same_device(x, centroids).type == "cuda":
        from repro_torch.kernels.assign.assign import assign_cuda

        return assign_cuda(x, centroids)
    return assign_ref(x, centroids)
