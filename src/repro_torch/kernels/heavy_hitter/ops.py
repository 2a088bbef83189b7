"""Dispatcher for the heavy-hitter counter's batch update: a CPU tensor
runs the plain version, a CUDA tensor launches the kernel, anything else
raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_same_device
from repro_torch.kernels.heavy_hitter import ref


def update_batch(cfg, state, labels: torch.Tensor, draws: dict):
    """The per-arrival update of ``state`` over ``labels`` [B] i32 (−1
    dropped) with the given draws; see ``ref.update_batch_ref``."""
    dev = check_same_device(labels, state.labels, *draws.values())
    if dev.type == "cuda":
        from repro_torch.kernels.heavy_hitter.heavy_hitter import update_batch_cuda

        return update_batch_cuda(cfg, state, labels, draws)
    return ref.update_batch_ref(cfg, state, labels, draws)
