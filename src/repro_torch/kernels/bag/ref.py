"""Plain PyTorch version of the ``bag`` kernel: EmbeddingBag, a weighted
row gather summed into bags, optionally averaged over each bag's entry
count."""
from __future__ import annotations

import torch

from repro_torch.kernels.counts import COUNTS


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      segment_ids: torch.Tensor, num_bags: int,
                      weights: torch.Tensor | None = None, mode: str = "sum"):
    """out[b] = reduce_{i: segment_ids[i] == b} w[i] * table[indices[i]].

    table [V, d] (f32 or bf16, rows widened to f32); indices, segment_ids
    [L] ints (segments in [0, num_bags), need not be sorted); weights [L]
    or None (ones). ``mode="mean"`` divides by the bag's number of
    entries, not by the sum of its weights (MIND passes w = mask and
    expects the mean over the whole history). Returns [num_bags, d] f32;
    empty bags are zero."""
    COUNTS["bag"].plain += 1
    rows = table[indices.long()].to(torch.float32)
    if weights is not None:
        rows = rows * weights[:, None].to(torch.float32)
    seg = segment_ids.long()
    out = torch.zeros((num_bags, table.shape[1]), dtype=torch.float32,
                      device=table.device).index_add_(0, seg, rows)
    if mode == "mean":
        cnt = torch.zeros((num_bags,), dtype=torch.float32,
                          device=table.device).index_add_(
                              0, seg, torch.ones_like(rows[:, 0]))
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def embedding_bag_sorted_ref(table: torch.Tensor, indices: torch.Tensor,
                             segment_ids: torch.Tensor, num_bags: int,
                             weights: torch.Tensor | None = None, mode: str = "sum"):
    """``embedding_bag_ref`` for segment ids the caller states are
    non-decreasing (the kernel's sorted entry, which skips the sort);
    raises if they are not."""
    if segment_ids.numel() > 1 and bool((segment_ids[1:] < segment_ids[:-1]).any()):
        raise ValueError("embedding_bag_sorted: segment_ids must be non-decreasing")
    return embedding_bag_ref(table, indices, segment_ids, num_bags, weights, mode)
