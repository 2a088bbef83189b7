"""Dispatcher for EmbeddingBag: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.bag.ref import embedding_bag_ref
from repro_torch.kernels.common import check_same_device


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, num_bags: int,
                  weights: torch.Tensor | None = None, mode: str = "sum"):
    """EmbeddingBag over a ragged multi-hot batch: [num_bags, d] f32 (see
    ``ref.embedding_bag_ref``)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', not {mode!r}")
    if check_same_device(table, indices, segment_ids, weights).type == "cuda":
        from repro_torch.kernels.bag.bag import embedding_bag_cuda

        return embedding_bag_cuda(table, indices, segment_ids, num_bags, weights, mode)
    return embedding_bag_ref(table, indices, segment_ids, num_bags, weights, mode)
