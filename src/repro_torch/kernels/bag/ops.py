"""Dispatcher for EmbeddingBag: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel, a ``meta`` tensor gets the outputs'
shapes and dtypes (forward and backward alike), anything else raises.

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
``jax.ops.segment_sum``.

``segment_order(ids, n)`` sorts an id set once (the kernel's own sort,
run alone); ``segment_sum``, ``gather_rows`` and ``gather_backward`` take
it as ``order=`` and then sort nothing, with the same result bit for bit.
On the CPU the plain versions sum the ids in that order, which is theirs
(the sort is stable)."""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.bag.ref import (SegmentOrder, embedding_bag_backward_ref,
                                         embedding_bag_ref, embedding_bag_sorted_ref,
                                         gather_backward_ref, order_splits, segment_order_ref,
                                         segment_sum_ref)
from repro_torch.kernels.common import check_same_device


def _check_mode(mode: str) -> None:
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', not {mode!r}")


def _forward(table, indices, segment_ids, num_bags, weights, mode, is_sorted, kernel):
    def run():
        if table.is_meta:
            return torch.empty((num_bags, table.shape[1]), dtype=torch.float32,
                               device=table.device)
        if kernel:
            from repro_torch.kernels.bag import bag

            fn = bag.embedding_bag_sorted_cuda if is_sorted else bag.embedding_bag_cuda
        else:
            fn = embedding_bag_sorted_ref if is_sorted else embedding_bag_ref
        return fn(table, indices, segment_ids, num_bags, weights, mode)

    return cost.entry("bag", run, lambda out: cost.bag(
        indices.numel(), table.shape[1], num_bags, table.element_size(),
        cost.distinct(indices)))


def _backward(table, indices, segment_ids, num_bags, grad_out, weights, mode,
              weights_grad, kernel):
    """(d_table, d_w | None) by the ``bag_backward`` kernel (``kernel``),
    its plain version, or on ``meta`` their shapes and dtypes."""
    def run():
        if table.is_meta:
            V, d = table.shape
            d_w = (torch.empty((indices.shape[0],), dtype=torch.float32, device=table.device)
                   if weights_grad else None)
            return torch.empty((V, d), dtype=table.dtype, device=table.device), d_w
        if kernel:
            from repro_torch.kernels.bag.bag import embedding_bag_backward_cuda as fn
        else:
            fn = embedding_bag_backward_ref
        return fn(table, indices, segment_ids, num_bags, grad_out, weights, mode,
                  weights_grad=weights_grad)

    V, d = table.shape
    return cost.entry("bag_backward", run, lambda out: cost.bag_backward(
        V, d, indices.numel(), num_bags, table.element_size(), indices.element_size(),
        segment_ids.element_size(), weights is not None, weights_grad,
        cost.distinct(indices) if weights_grad else 0))


def _gather_backward(table, ids, grad_out, kernel, order=None):
    def run():
        if table.is_meta:
            return torch.empty(table.shape, dtype=table.dtype, device=table.device)
        if kernel:
            from repro_torch.kernels.bag.bag import gather_backward_cuda

            return gather_backward_cuda(table, ids, grad_out, order)
        if order is None:
            return gather_backward_ref(table, ids, grad_out)
        g = grad_out.reshape(-1, table.shape[1])[order.pos.long()]
        return gather_backward_ref(table, order.keys, g)

    V, d = table.shape
    return cost.entry("gather_backward", run, lambda out: cost.gather_backward(
        V, d, ids.numel(), table.element_size(), ids.element_size()))


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
        d_table, d_w = _backward(table, indices, segment_ids, ctx.num_bags,
                                 grad_out.contiguous(), weights, ctx.mode,
                                 ctx.needs_input_grad[1], ctx.kernel)
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


def embedding_bag_backward(table: torch.Tensor, indices: torch.Tensor,
                           segment_ids: torch.Tensor, num_bags: int, grad_out: torch.Tensor,
                           weights: torch.Tensor | None = None, mode: str = "sum",
                           weights_grad: bool = False):
    """The gradient of ``embedding_bag`` given ``grad_out`` [num_bags, d]:
    (d_table [V, d] in the table's dtype, d_w [L] f32 or None) (see
    ``ref.embedding_bag_backward_ref``)."""
    _check_mode(mode)
    kernel = check_same_device(table, indices, segment_ids, grad_out,
                               weights).type == "cuda"
    return _backward(table, indices, segment_ids, num_bags, grad_out, weights, mode,
                     weights_grad, kernel)


def gather_backward(table: torch.Tensor, ids: torch.Tensor, grad_out: torch.Tensor, *,
                    order: SegmentOrder | None = None) -> torch.Tensor:
    """The gradient of ``table[ids]`` given ``grad_out`` [*ids.shape, d]:
    dense [V, d] in the table's dtype (see ``ref.gather_backward_ref``).
    ``order``: ``segment_order(ids, V)``, made once for every sum over
    these ids."""
    kernel = check_same_device(table, ids, grad_out, *(order or ())).type == "cuda"
    return _gather_backward(table, ids, grad_out, kernel, order)


class _Gather(torch.autograd.Function):
    """``table[ids]`` whose gradient is ``gather_backward`` (``kernel``) or
    its plain version, over ``order`` where one is given."""

    @staticmethod
    def forward(ctx, table, ids, kernel, order):
        ctx.save_for_backward(table, ids)
        ctx.kernel, ctx.order = kernel, order
        return table[ids.long()]

    @staticmethod
    def backward(ctx, grad_out):
        table, ids = ctx.saved_tensors
        return _gather_backward(table, ids, grad_out, ctx.kernel, ctx.order), None, None, None


def gather_apply(table: torch.Tensor, ids: torch.Tensor, kernel: bool,
                 order: SegmentOrder | None = None) -> torch.Tensor:
    """``table[ids]``; where ``table`` requires grad, an autograd node whose
    backward is the ``gather_backward`` kernel (``kernel``) or its plain
    version."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _Gather.apply(table, ids, kernel, order)
    return table[ids.long()]


def gather_rows(table: torch.Tensor, ids: torch.Tensor, *,
                order: SegmentOrder | None = None) -> torch.Tensor:
    """Rows of a [V, d] table: ``table[ids]``, [*ids.shape, d]. ``order``:
    ``segment_order(ids, V)``, for the gradient."""
    kernel = check_same_device(table, ids, *(order or ())).type == "cuda"
    return gather_apply(table, ids, kernel, order)


def segment_order(ids: torch.Tensor, num_rows: int) -> SegmentOrder:
    """``ids`` (any shape, values in [0, num_rows)) sorted once for every
    sum over them: ``ref.SegmentOrder``, by the kernel's own sort on the
    card, its plain version on the CPU."""
    dev = check_same_device(ids)
    L = ids.numel()

    def run():
        if dev.type == "meta":
            def i32(*shape):
                return torch.empty(shape, dtype=torch.int32, device=dev)
            return SegmentOrder(i32(L), i32(L), i32(num_rows + 1),
                                i32(order_splits(num_rows, L) + 1, 2))
        if dev.type == "cuda":
            from repro_torch.kernels.bag.bag import segment_order_cuda

            return segment_order_cuda(ids, num_rows)
        return segment_order_ref(ids, num_rows)

    return cost.entry("segment_order", run, lambda out: cost.segment_order(
        L, num_rows, ids.element_size(), order_splits(num_rows, L)))


def _segment_sum(data, segment_ids, num_segments, kernel, order=None):
    def run():
        if data.is_meta:
            return torch.empty((num_segments, data.shape[1]), dtype=data.dtype,
                               device=data.device)
        if kernel:
            from repro_torch.kernels.bag.bag import segment_sum_cuda

            return segment_sum_cuda(data, segment_ids, num_segments, order)
        if order is None:
            return segment_sum_ref(data, segment_ids, num_segments)
        return segment_sum_ref(data[order.pos.long()], order.keys, num_segments)

    L, d = data.shape
    return cost.entry("segment_sum", run, lambda out: cost.segment_sum(
        L, d, num_segments, data.element_size(), segment_ids.element_size()))


class _SegmentSum(torch.autograd.Function):
    """``segment_sum`` by the kernel (``kernel``) or its plain version;
    its gradient is ``grad[segment_ids]``."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, kernel, order):
        ctx.save_for_backward(segment_ids)
        return _segment_sum(data, segment_ids, num_segments, kernel, order)

    @staticmethod
    def backward(ctx, grad_out):
        (segment_ids,) = ctx.saved_tensors
        return grad_out[segment_ids.long()], None, None, None, None


def segment_sum_apply(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                      kernel: bool, order: SegmentOrder | None = None) -> torch.Tensor:
    """The segment sum by the kernel (``kernel``) or its plain version, on
    the tensors' own device; an autograd node where ``data`` requires
    grad."""
    if torch.is_grad_enabled() and data.requires_grad:
        return _SegmentSum.apply(data, segment_ids, num_segments, kernel, order)
    return _segment_sum(data, segment_ids, num_segments, kernel, order)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *,
                order: SegmentOrder | None = None) -> torch.Tensor:
    """[num_segments, d]: out[s] = sum_{i: segment_ids[i] = s} data[i]
    for [L, d] data and [L] ids (see ``ref.segment_sum_ref``). ``order``:
    ``segment_order(segment_ids, num_segments)``, made once for every sum
    over these ids."""
    kernel = check_same_device(data, segment_ids, *(order or ())).type == "cuda"
    return segment_sum_apply(data, segment_ids, num_segments, kernel, order)
