"""Plain PyTorch versions of the ``bag`` kernels: EmbeddingBag, a weighted
row gather summed into bags, optionally averaged over each bag's entry
count; its gradient (``bag_backward``); the gradient of a row gather
``table[ids]`` (``gather_backward``), the same sum with one entry a bag;
and the stable sort of an id set that a caller hands to each of its sums
(``segment_order``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.counts import COUNTS

ORDER_ROW_ITEMS = 32   # bag_backward.cu's kRowItems: rows + entries a warp of an ordered sum takes


class SegmentOrder(NamedTuple):
    """An id set sorted once, for every sum over it (``segment_sum``,
    ``gather_backward`` with ``order=``): ``keys`` [L] int32 the ids in
    non-decreasing order, equal ids in their original order; ``pos`` [L]
    int32 each sorted id's position in the (flattened) ids; ``offsets``
    [num_rows + 1] int32, row r's sorted entries [offsets[r], offsets[r +
    1]); ``splits`` [order_splits(num_rows, L) + 1, 2] int32, (r,
    offsets[r]) for r the first row with r + offsets[r] >= w * 32
    (num_rows where none is): the first row the card's warp w sums, and
    its first sorted entry."""

    keys: torch.Tensor
    pos: torch.Tensor
    offsets: torch.Tensor
    splits: torch.Tensor


def order_splits(num_rows: int, L: int) -> int:
    """The warps an ordered sum over ``num_rows`` rows and ``L`` entries
    takes: each at most ``ORDER_ROW_ITEMS`` rows + entries."""
    return -(-(num_rows + L) // ORDER_ROW_ITEMS)


def segment_order_ref(ids: torch.Tensor, num_rows: int) -> SegmentOrder:
    """The order of ``ids`` (any shape, flattened; values in [0,
    num_rows)) as ``SegmentOrder`` describes it: a stable sort, each row's
    extent by a search, and the warps' rows."""
    COUNTS["segment_order"].plain += 1
    flat = ids.reshape(-1)
    keys, pos = torch.sort(flat, stable=True)
    dev = flat.device
    rows = torch.arange(num_rows + 1, device=dev, dtype=keys.dtype)
    offsets = torch.searchsorted(keys, rows)
    items = torch.arange(num_rows, device=dev) + offsets[:-1]
    want = torch.arange(order_splits(num_rows, flat.numel()) + 1, device=dev) * ORDER_ROW_ITEMS
    first = torch.searchsorted(items, want)
    splits = torch.stack([first, offsets[first]], dim=1)
    return SegmentOrder(keys.to(torch.int32), pos.to(torch.int32), offsets.to(torch.int32),
                        splits.to(torch.int32))


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


def embedding_bag_backward_ref(table: torch.Tensor, indices: torch.Tensor,
                               segment_ids: torch.Tensor, num_bags: int,
                               grad_out: torch.Tensor,
                               weights: torch.Tensor | None = None, mode: str = "sum",
                               weights_grad: bool = False):
    """The gradient of ``embedding_bag_ref`` given ``grad_out`` [num_bags,
    d], as the reference's autodiff of its ``embedding_bag_ref`` computes
    it, op for op: g = grad_out / max(c, 1) per bag (c its entry count;
    mean mode only), then

        d_table[v] = sum_{i: indices[i] = v} g[seg[i]] * w[i]   (dense [V, d],
                     summed in f32, returned in the table's dtype)
        d_w[i]     = <table[indices[i]], g[seg[i]]>            (f32 [L], only
                     when ``weights_grad``; else None)

    Rows no entry touches are zero."""
    COUNTS["bag_backward"].plain += 1
    seg = segment_ids.long()
    g = grad_out.to(torch.float32)
    if mode == "mean":
        cnt = torch.zeros((num_bags,), dtype=torch.float32,
                          device=g.device).index_add_(
                              0, seg, torch.ones(seg.shape, dtype=torch.float32,
                                                 device=g.device))
        g = g / torch.clamp(cnt, min=1.0)[:, None]
    gi = g[seg]                                            # [L, d]
    d_w = None
    if weights_grad:
        d_w = torch.sum(table[indices.long()].to(torch.float32) * gi, dim=1)
    rows = gi if weights is None else gi * weights[:, None].to(torch.float32)
    d_table = torch.zeros(table.shape, dtype=torch.float32,
                          device=table.device).index_add_(0, indices.long(), rows)
    return d_table.to(table.dtype), d_w


def gather_backward_ref(table: torch.Tensor, ids: torch.Tensor,
                        grad_out: torch.Tensor) -> torch.Tensor:
    """The gradient of ``table[ids]`` given ``grad_out`` [*ids.shape, d]:
    d_table[v] = sum_{i: ids[i] = v} grad_out[i], dense [V, d] in the
    table's dtype, summed in f32 (a float64 table in float64) (the
    transpose of the reference's ``jnp.take`` row gathers)."""
    COUNTS["gather_backward"].plain += 1
    d = table.shape[1]
    acc = torch.promote_types(table.dtype, torch.float32)
    return torch.zeros(table.shape, dtype=acc, device=table.device).index_add_(
        0, ids.reshape(-1).long(), grad_out.reshape(-1, d).to(acc)).to(table.dtype)


def segment_sum_ref(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """out[s] = sum_{i: segment_ids[i] = s} data[i]: dense [num_segments,
    d] in data's dtype, summed in f32 (float64 data in float64), empty
    segments zero (``jax.ops.segment_sum``)."""
    COUNTS["segment_sum"].plain += 1
    acc = torch.promote_types(data.dtype, torch.float32)
    return torch.zeros((num_segments, data.shape[1]), dtype=acc,
                       device=data.device).index_add_(
        0, segment_ids.long(), data.to(acc)).to(data.dtype)
