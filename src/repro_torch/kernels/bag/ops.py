"""Dispatcher for EmbeddingBag: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel, anything else raises.

``embedding_bag`` takes segment ids in any order (the kernel's wrapper
sorts them first, as the reference's wrapper does); ``embedding_bag_sorted``
is for callers whose segment ids are non-decreasing by construction: on
the card it is the kernel's launch alone, with no sort."""
from __future__ import annotations

import torch

from repro_torch.kernels.bag.ref import embedding_bag_ref, embedding_bag_sorted_ref
from repro_torch.kernels.common import check_same_device


def _check_mode(mode: str) -> None:
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', not {mode!r}")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, num_bags: int,
                  weights: torch.Tensor | None = None, mode: str = "sum"):
    """EmbeddingBag over a ragged multi-hot batch: [num_bags, d] f32 (see
    ``ref.embedding_bag_ref``)."""
    _check_mode(mode)
    if check_same_device(table, indices, segment_ids, weights).type == "cuda":
        from repro_torch.kernels.bag.bag import embedding_bag_cuda

        return embedding_bag_cuda(table, indices, segment_ids, num_bags, weights, mode)
    return embedding_bag_ref(table, indices, segment_ids, num_bags, weights, mode)


def embedding_bag_sorted(table: torch.Tensor, indices: torch.Tensor,
                         segment_ids: torch.Tensor, num_bags: int,
                         weights: torch.Tensor | None = None, mode: str = "sum"):
    """``embedding_bag`` for segment ids the caller states are
    non-decreasing. The card cannot check that without a host sync, so it
    does not; the plain version checks it and raises."""
    _check_mode(mode)
    if check_same_device(table, indices, segment_ids, weights).type == "cuda":
        from repro_torch.kernels.bag.bag import embedding_bag_sorted_cuda

        return embedding_bag_sorted_cuda(table, indices, segment_ids, num_bags, weights,
                                         mode)
    return embedding_bag_sorted_ref(table, indices, segment_ids, num_bags, weights, mode)
