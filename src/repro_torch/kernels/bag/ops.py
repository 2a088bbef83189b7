"""Dispatcher for EmbeddingBag: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel, anything else raises.

``embedding_bag`` takes segment ids in any order (the kernel's wrapper
sorts them first, as the reference's wrapper does); ``embedding_bag_sorted``
is for callers whose segment ids are non-decreasing by construction: on
the card it is the kernel's launch alone, with no sort.

Both are differentiable with respect to ``table``, and to ``weights``
where those require grad: a ``torch.autograd.Function`` runs the forward
and, for the gradient, the ``bag_backward`` kernel on the card (its plain
version, ``ref.embedding_bag_backward_ref``, on the CPU). Where nothing
requires grad the forward runs alone, with no autograd node.

``gather_rows(table, ids)`` is ``table[ids]`` whose gradient is the same
kernel with one entry a bag (``gather_backward``): PyTorch's own
backward of that indexing serialises on a row that many ids share (the
padding row 0 of a history batch).

``segment_sum(data, ids, n)`` is that kernel's sum run forward (the
GNN's aggregation into destination nodes): deterministic, where
``index_add_`` on the card adds with float atomics in no fixed order. Its
gradient is the row gather ``grad[ids]``, as the reference's transpose of
``jax.ops.segment_sum``."""
from __future__ import annotations

import torch

from repro_torch.kernels.bag.ref import (embedding_bag_backward_ref, embedding_bag_ref,
                                         embedding_bag_sorted_ref, gather_backward_ref,
                                         segment_sum_ref)
from repro_torch.kernels.common import check_same_device


def _check_mode(mode: str) -> None:
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', not {mode!r}")


def _forward(table, indices, segment_ids, num_bags, weights, mode, is_sorted, kernel):
    if kernel:
        from repro_torch.kernels.bag import bag

        fn = bag.embedding_bag_sorted_cuda if is_sorted else bag.embedding_bag_cuda
    else:
        fn = embedding_bag_sorted_ref if is_sorted else embedding_bag_ref
    return fn(table, indices, segment_ids, num_bags, weights, mode)


class _Bag(torch.autograd.Function):
    """EmbeddingBag whose gradient is the ``bag_backward`` kernel
    (``kernel``) or its plain version."""

    @staticmethod
    def forward(ctx, table, weights, indices, segment_ids, num_bags, mode, is_sorted,
                kernel):
        ctx.save_for_backward(table, weights, indices, segment_ids)
        ctx.num_bags, ctx.mode, ctx.kernel = num_bags, mode, kernel
        return _forward(table, indices, segment_ids, num_bags, weights, mode, is_sorted,
                        kernel)

    @staticmethod
    def backward(ctx, grad_out):
        table, weights, indices, segment_ids = ctx.saved_tensors
        if ctx.kernel:
            from repro_torch.kernels.bag.bag import embedding_bag_backward_cuda as fn
        else:
            fn = embedding_bag_backward_ref
        d_table, d_w = fn(table, indices, segment_ids, ctx.num_bags,
                          grad_out.contiguous(), weights, ctx.mode,
                          weights_grad=ctx.needs_input_grad[1])
        if d_w is not None:
            d_w = d_w.to(weights.dtype)
        return (d_table if ctx.needs_input_grad[0] else None, d_w,
                None, None, None, None, None, None)


def bag_apply(table: torch.Tensor, indices: torch.Tensor, segment_ids: torch.Tensor,
              num_bags: int, weights: torch.Tensor | None, mode: str, is_sorted: bool,
              kernel: bool):
    """The forward (``kernel``: the CUDA kernels, else the plain versions,
    on the tensors' own device), as an autograd node where ``table`` or
    ``weights`` require grad."""
    _check_mode(mode)
    if torch.is_grad_enabled() and (table.requires_grad or (
            weights is not None and weights.requires_grad)):
        return _Bag.apply(table, weights, indices, segment_ids, num_bags, mode, is_sorted,
                          kernel)
    return _forward(table, indices, segment_ids, num_bags, weights, mode, is_sorted, kernel)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, num_bags: int,
                  weights: torch.Tensor | None = None, mode: str = "sum"):
    """EmbeddingBag over a ragged multi-hot batch: [num_bags, d] f32 (see
    ``ref.embedding_bag_ref``)."""
    _check_mode(mode)
    kernel = check_same_device(table, indices, segment_ids, weights).type == "cuda"
    return bag_apply(table, indices, segment_ids, num_bags, weights, mode, False, kernel)


def embedding_bag_sorted(table: torch.Tensor, indices: torch.Tensor,
                         segment_ids: torch.Tensor, num_bags: int,
                         weights: torch.Tensor | None = None, mode: str = "sum"):
    """``embedding_bag`` for segment ids the caller states are
    non-decreasing. The card cannot check that without a host sync, so it
    does not; the plain version checks it and raises."""
    _check_mode(mode)
    kernel = check_same_device(table, indices, segment_ids, weights).type == "cuda"
    return bag_apply(table, indices, segment_ids, num_bags, weights, mode, True, kernel)


class _Gather(torch.autograd.Function):
    """``table[ids]`` whose gradient is ``gather_backward`` (``kernel``) or
    its plain version."""

    @staticmethod
    def forward(ctx, table, ids, kernel):
        ctx.save_for_backward(table, ids)
        ctx.kernel = kernel
        return table[ids.long()]

    @staticmethod
    def backward(ctx, grad_out):
        table, ids = ctx.saved_tensors
        if ctx.kernel:
            from repro_torch.kernels.bag.bag import gather_backward_cuda as fn
        else:
            fn = gather_backward_ref
        return fn(table, ids, grad_out), None, None


def gather_apply(table: torch.Tensor, ids: torch.Tensor, kernel: bool) -> torch.Tensor:
    """``table[ids]``; where ``table`` requires grad, an autograd node whose
    backward is the ``gather_backward`` kernel (``kernel``) or its plain
    version."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _Gather.apply(table, ids, kernel)
    return table[ids.long()]


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of a [V, d] table: ``table[ids]``, [*ids.shape, d]."""
    kernel = check_same_device(table, ids).type == "cuda"
    return gather_apply(table, ids, kernel)


def _segment_sum(data, segment_ids, num_segments, kernel):
    if kernel:
        from repro_torch.kernels.bag.bag import segment_sum_cuda as fn
    else:
        fn = segment_sum_ref
    return fn(data, segment_ids, num_segments)


class _SegmentSum(torch.autograd.Function):
    """``segment_sum`` by the kernel (``kernel``) or its plain version;
    its gradient is ``grad[segment_ids]``."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, kernel):
        ctx.save_for_backward(segment_ids)
        return _segment_sum(data, segment_ids, num_segments, kernel)

    @staticmethod
    def backward(ctx, grad_out):
        (segment_ids,) = ctx.saved_tensors
        return grad_out[segment_ids.long()], None, None, None


def segment_sum_apply(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                      kernel: bool) -> torch.Tensor:
    """The segment sum by the kernel (``kernel``) or its plain version, on
    the tensors' own device; an autograd node where ``data`` requires
    grad."""
    if torch.is_grad_enabled() and data.requires_grad:
        return _SegmentSum.apply(data, segment_ids, num_segments, kernel)
    return _segment_sum(data, segment_ids, num_segments, kernel)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """[num_segments, d]: out[s] = sum_{i: segment_ids[i] = s} data[i]
    for [L, d] data and [L] ids (see ``ref.segment_sum_ref``)."""
    kernel = check_same_device(data, segment_ids).type == "cuda"
    return segment_sum_apply(data, segment_ids, num_segments, kernel)
