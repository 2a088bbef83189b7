"""ctypes wrappers of the hand-written CUDA ``bag`` kernels: EmbeddingBag
(``repro_torch/csrc/bag.cu``: one warp per bag over entries sorted by
bag) and its gradient (``repro_torch/csrc/bag_backward.cu``: a stable
radix sort of the entries by row, runs that span chunks summed into
pieces, and one dense pass that writes every row once), whose entry also
takes a row gather's gradient (``gather_backward_cuda``) and, the same
sum, a segment sum (``segment_sum_cuda``). Its sort alone
(``segment_order_cuda``) orders an id set once for every sum over it:
given that order, those two run no sort (``bag_rows_launch``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import SMS, cdiv
from repro_torch.kernels.bag.ref import ORDER_ROW_ITEMS, SegmentOrder, order_splits
from repro_torch.kernels.counts import COUNTS

INDEX_DTYPES = (torch.int32, torch.int64)


def _fn():
    lib = build.load("bag")
    fn = lib.bag_launch
    if fn.argtypes is None:
        P, I = build.P, build.I
        fn.argtypes = [P, I, I, P, I, P, I, P, I, I, I, I, P, P]
        fn.restype = I
    return lib, fn


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       segment_ids: torch.Tensor, num_bags: int,
                       weights: torch.Tensor | None = None, mode: str = "sum"):
    """Same function as ``ref.embedding_bag_ref``; every tensor on one CUDA
    device; segment ids in any order. What the reference's wrapper does
    outside its ``pallas_call`` happens here: a stable sort by bag (as
    ``jnp.argsort``) makes each bag's entries contiguous in their original
    order, which is the order the kernel sums them in."""
    order = torch.argsort(segment_ids, stable=True)
    idx = indices[order]
    if idx.dtype not in INDEX_DTYPES:
        idx = idx.to(torch.int32)
    seg = segment_ids[order]
    if seg.dtype not in INDEX_DTYPES:
        seg = seg.to(torch.int32)
    w = None if weights is None else weights[order].to(torch.float32)
    return embedding_bag_sorted_cuda(table, idx, seg, num_bags, w, mode)


def embedding_bag_sorted_cuda(table: torch.Tensor, indices: torch.Tensor,
                              segment_ids: torch.Tensor, num_bags: int,
                              weights: torch.Tensor | None = None, mode: str = "sum"):
    """The launch alone, on the caller's tensors as they are: indices and
    segment_ids [L] int32 or int64, segment_ids non-decreasing in
    [0, num_bags) (not checked: that would need a host sync), weights [L]
    float32 or None (ones); table [V, d] f32 or bf16, contiguous, every
    index in [0, V) (not checked either)."""
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("bag kernel takes a [V, d] float32 or bfloat16 table")
    L = indices.shape[0]
    for name, t, dts in (("indices", indices, INDEX_DTYPES),
                         ("segment_ids", segment_ids, INDEX_DTYPES),
                         ("weights", weights, (torch.float32,))):
        if t is not None and (t.dtype not in dts or t.shape != (L,)
                              or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous [L] tensor of {dts}")
    if not table.is_contiguous():
        raise ValueError("bag kernel takes a contiguous table")
    if L >= 2**31 or num_bags >= 2**31:
        raise ValueError("bag kernel counts entries and bags in 32 bits")
    if mode not in ("sum", "mean") or num_bags < 0:
        raise ValueError(f"mode {mode!r}, num_bags {num_bags}")
    d = table.shape[1]
    out = torch.empty((num_bags, d), dtype=torch.float32, device=table.device)
    if num_bags == 0 or d == 0:
        return out
    lib, fn = _fn()
    err = fn(table.data_ptr(), int(table.dtype == torch.bfloat16), d, indices.data_ptr(),
             int(indices.dtype == torch.int64), segment_ids.data_ptr(),
             int(segment_ids.dtype == torch.int64), build.ptr(weights), L, num_bags,
             int(mode == "mean"), SMS, out.data_ptr(), build.stream_of(table.device))
    build.check(lib, err, "bag_launch")
    COUNTS["bag"].kernel += 1
    return out


BWD_CHUNK = 256        # sorted entries a warp sums into a piece (bag_backward.cu's kChunk)
BWD_GROUP = 64         # chunks a level-2 sum covers (kGroup)
BWD_TILE = 4096        # entries a sort block ranks in a pass (kTile)
BWD_MAX_DIGIT = 11     # bits a sort pass takes at most (its radix at most 2048)
_ALIGN = 256           # bytes each scratch region starts on


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How ``bag_backward.cu`` runs on V rows and L entries: the stable
    LSD sort's digit passes (bits each, lowest digit first: together the
    ceil(log2 V) bits a row id has, at least 1) and the scratch regions
    (name, bytes) in the order they lie in one buffer, each on a 256-byte
    boundary."""

    widths: tuple[int, ...]
    regions: tuple[tuple[str, int], ...]

    def offsets(self) -> dict[str, int]:
        out, at = {}, 0
        for name, nbytes in self.regions:
            out[name] = at
            at += cdiv(nbytes, _ALIGN) * _ALIGN
        return out

    @property
    def scratch_bytes(self) -> int:
        return sum(cdiv(nbytes, _ALIGN) * _ALIGN for _, nbytes in self.regions)


def sort_widths(V: int) -> tuple[int, ...]:
    """The sort's digit passes over row ids below V, lowest digit first:
    the ceil(log2 V) bits (at least 1) split as evenly as passes of at
    most 11 bits allow."""
    bits = max(1, (V - 1).bit_length())
    npasses = cdiv(bits, BWD_MAX_DIGIT)
    base, extra = divmod(bits, npasses)
    return tuple(base + (p < extra) for p in range(npasses))


def backward_plan(V: int, L: int, d: int, num_bags: int, weighted: bool,
                  mean: bool) -> BackwardPlan:
    """The plan of one call (``weighted``: weights given; ``mean``: mean
    mode). The passes split the row id's bits as evenly as passes of at
    most 11 bits allow: 20 bits at V = 10^6 take 10 + 10, 23 bits (V =
    2^22 + 3) 8 + 8 + 7. Tile counts are kept for the widest pass's radix;
    pieces are two a chunk of 256 sorted entries, level-2 sums one a full
    group of 64 chunks."""
    widths = sort_widths(V)
    npasses = len(widths)
    radix, tiles = 1 << max(widths), cdiv(L, BWD_TILE)
    chunks, groups = cdiv(L, BWD_CHUNK), L // (BWD_GROUP * BWD_CHUNK)
    w_bytes = 4 * L if weighted else 0
    regions = (("keys_a", 4 * L), ("keys_b", 4 * L), ("bags_a", 4 * L), ("bags_b", 4 * L),
               ("w_a", w_bytes), ("w_b", w_bytes),
               ("counts_a", 4 * radix * tiles), ("counts_b", 4 * radix * tiles * (npasses > 1)),
               ("totals", 4 * radix), ("touched", V), ("row_start", 4 * V),
               ("pieces", 4 * 2 * chunks * d), ("level2", 4 * groups * d),
               ("cnt", 4 * num_bags if mean else 0), ("gs", 4 * num_bags * d if mean else 0))
    return BackwardPlan(widths, regions)


def _bwd_fn():
    lib = build.load("bag_backward")
    fn = lib.bag_backward_launch
    if fn.argtypes is None:
        P, I = build.P, build.I
        fn.argtypes = [P, I, I, I, P, I, P, I, P, P, I, I, I, P, P, I, I, I, I, I,
                       *[P] * 15, P]
        fn.restype = I
        lib.bag_order_launch.argtypes = [P, I, I, I, I, I, I, I, *[P] * 8, I, P, P]
        lib.bag_order_launch.restype = I
        lib.bag_rows_launch.argtypes = [P, I, I, I, I, P, P, P, P, I, P, P, P, P]
        lib.bag_rows_launch.restype = I
        lib.bag_order_rows_per_warp.restype = I
        if lib.bag_order_rows_per_warp() != ORDER_ROW_ITEMS:
            raise RuntimeError("bag_backward.cu's rows a warp differs from the wrapper's")
    return lib, fn


def segment_order_cuda(ids: torch.Tensor, num_rows: int) -> SegmentOrder:
    """Same contract as ``ref.segment_order_ref``, bit for bit: the ids
    (int32 or int64, any shape, flattened; in [0, num_rows), not checked)
    sorted once by ``bag_backward.cu``'s own stable radix sort (the passes
    of ``sort_widths(num_rows)``), then each row's extent and each warp's
    rows by a binary search a row and a warp. Every sum over the same ids
    (``segment_sum_cuda``, ``gather_backward_cuda`` with ``order=``) reuses
    it and sorts nothing."""
    flat = ids.reshape(-1)
    if flat.dtype not in INDEX_DTYPES:
        raise TypeError(f"ids must be one of {INDEX_DTYPES}")
    flat = flat.contiguous()
    L = flat.shape[0]
    if L >= 2**31 or num_rows >= 2**31 or num_rows < 0:
        raise ValueError("segment_order counts entries and rows in 32 bits")
    dev = flat.device
    widths = sort_widths(num_rows)
    radix, tiles = 1 << max(widths), cdiv(L, BWD_TILE)
    nsplit = order_splits(num_rows, L)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    keys, pos = (i32(L), i32(L)), (i32(L), i32(L))
    counts = (i32(radix * tiles), i32(radix * tiles) if len(widths) > 1 else None)
    offsets, splits = i32(num_rows + 1), i32(nsplit + 1, 2)
    lib, _ = _bwd_fn()
    err = lib.bag_order_launch(flat.data_ptr(), int(flat.dtype == torch.int64), L, num_rows,
                               len(widths), *(*widths, 0, 0)[:3], keys[0].data_ptr(),
                               keys[1].data_ptr(), pos[0].data_ptr(), pos[1].data_ptr(),
                               counts[0].data_ptr(), build.ptr(counts[1]),
                               i32(radix).data_ptr(), offsets.data_ptr(), nsplit,
                               splits.data_ptr(), build.stream_of(dev))
    build.check(lib, err, "bag_order_launch")
    COUNTS["segment_order"].kernel += 1
    f = (len(widths) - 1) & 1   # the pass that wrote last
    return SegmentOrder(keys[f], pos[f], offsets, splits)


def _check_order(order: SegmentOrder, L: int, V: int, dev) -> None:
    want = ((L,), (L,), (V + 1,), (order_splits(V, L) + 1, 2))
    for t, shape in zip(order, want):
        if t.dtype != torch.int32 or t.shape != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"the order is not one of {L} ids over {V} rows on {dev}")


def _rows_launch(g: torch.Tensor, order: SegmentOrder, d_table: torch.Tensor) -> None:
    """``bag_rows_launch``: d_table [V, d] = the sum of g [L, d] f32 over
    a given order (no sort, every row written once, the bits of
    ``_backward_launch`` with no segments)."""
    dev, (V, d), L = d_table.device, d_table.shape, g.shape[0]
    _check_order(order, L, V, dev)
    chunks, groups = cdiv(L, BWD_CHUNK), L // (BWD_GROUP * BWD_CHUNK)
    pieces = torch.empty((2 * chunks, d), dtype=torch.float32, device=dev) if chunks else None
    level2 = torch.empty((groups, d), dtype=torch.float32, device=dev) if groups else None
    lib, _ = _bwd_fn()
    err = lib.bag_rows_launch(g.data_ptr(), d, L, V, int(d_table.dtype == torch.bfloat16),
                              order.keys.data_ptr(), order.pos.data_ptr(),
                              order.offsets.data_ptr(), order.splits.data_ptr(),
                              order.splits.shape[0] - 1, build.ptr(pieces), build.ptr(level2),
                              d_table.data_ptr(), build.stream_of(dev))
    build.check(lib, err, "bag_rows_launch")


def _backward_launch(table, indices, segment_ids, grad_out, weights, mean, num_bags,
                     d_table, d_w):
    """Plan the call and launch ``bag_backward.cu`` (``segment_ids``
    None: a gather's transpose, entry i is bag i). The rows, width, type
    and device are ``d_table``'s; ``table`` is read only for ``d_w``, and
    may be None where ``d_w`` is."""
    dev, (V, d), L = d_table.device, d_table.shape, indices.shape[0]
    plan = backward_plan(V, L, d, num_bags, weights is not None, mean)
    buf = torch.empty((plan.scratch_bytes,), dtype=torch.uint8, device=dev)
    at = plan.offsets()
    regions = [buf.data_ptr() + at[name] if nbytes else None for name, nbytes in plan.regions]
    widths = (*plan.widths, 0, 0)[:3]
    lib, fn = _bwd_fn()
    err = fn(build.ptr(table), int(d_table.dtype == torch.bfloat16), V, d, indices.data_ptr(),
             int(indices.dtype == torch.int64), build.ptr(segment_ids),
             int(segment_ids is not None and segment_ids.dtype == torch.int64),
             build.ptr(weights), grad_out.data_ptr(), int(mean), num_bags, L,
             d_table.data_ptr(), build.ptr(d_w), len(plan.widths), *widths, SMS, *regions,
             build.stream_of(dev))
    build.check(lib, err, "bag_backward_launch")


def _check_table(table, what):
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes a [V, d] float32 or bfloat16 table")
    if not table.is_contiguous():
        raise ValueError(f"{what} takes a contiguous table")


def embedding_bag_backward_cuda(table: torch.Tensor, indices: torch.Tensor,
                                segment_ids: torch.Tensor, num_bags: int,
                                grad_out: torch.Tensor,
                                weights: torch.Tensor | None = None, mode: str = "sum",
                                weights_grad: bool = False):
    """Same function as ``ref.embedding_bag_backward_ref``: (d_table [V, d]
    in the table's dtype, d_w [L] f32 or None); every tensor on one CUDA
    device, segment ids in any order. One call of ``bag_backward.cu``
    (its own stable sort of the entries by row, each bag's entry count in
    mean mode, the row sums and the dense pass) writes every row of
    d_table, allocated by ``torch.empty``, once; scratch is one buffer
    laid out by ``backward_plan``. The result is the same bit for bit from
    call to call."""
    _check_table(table, "bag_backward")
    V, d = table.shape
    L = indices.shape[0]
    for name, t, dts in (("indices", indices, INDEX_DTYPES),
                         ("segment_ids", segment_ids, INDEX_DTYPES),
                         ("weights", weights, (torch.float32,))):
        if t is not None and (t.dtype not in dts or t.shape != (L,)
                              or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous [L] tensor of {dts}")
    if grad_out.dtype != torch.float32 or grad_out.shape != (num_bags, d) \
            or not grad_out.is_contiguous():
        raise TypeError("grad_out must be a contiguous [num_bags, d] float32 tensor")
    if L >= 2**31 or V >= 2**31 or num_bags >= 2**31:
        raise ValueError("bag_backward counts entries, rows and bags in 32 bits")
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode {mode!r}")
    dev = table.device
    d_table = torch.empty((V, d), dtype=table.dtype, device=dev)
    d_w = torch.zeros((L,), dtype=torch.float32, device=dev) if weights_grad else None
    if V == 0 or d == 0:
        return d_table, d_w
    _backward_launch(table, indices, segment_ids, grad_out, weights, mode == "mean",
                     num_bags, d_table, d_w)
    COUNTS["bag_backward"].kernel += 1
    return d_table, d_w


def gather_backward_cuda(table: torch.Tensor, ids: torch.Tensor,
                         grad_out: torch.Tensor, order: SegmentOrder | None = None
                         ) -> torch.Tensor:
    """Same function as ``ref.gather_backward_ref``: the dense gradient of
    ``table[ids]`` ([V, d] in the table's dtype), by ``bag_backward.cu``
    with one entry a bag (no segments, every weight 1: the sort carries
    each id's position); ``grad_out`` [*ids.shape, d], widened to f32.
    With ``order`` (``segment_order_cuda(ids, V)``) it sorts nothing. The
    same bits every call, with or without an order."""
    _check_table(table, "gather_backward")
    V, d = table.shape
    flat = ids.reshape(-1)
    if flat.dtype not in INDEX_DTYPES:
        raise TypeError(f"ids must be one of {INDEX_DTYPES}")
    flat = flat.contiguous()
    L = flat.shape[0]
    g = grad_out.reshape(L, d).to(torch.float32).contiguous()
    if L >= 2**31 or V >= 2**31:
        raise ValueError("gather_backward counts entries and rows in 32 bits")
    d_table = torch.empty((V, d), dtype=table.dtype, device=table.device)
    if V == 0 or d == 0:
        return d_table
    if order is None:
        _backward_launch(table, flat, None, g, None, False, L, d_table, None)
    else:
        _rows_launch(g, order, d_table)
    COUNTS["gather_backward"].kernel += 1
    return d_table


def segment_sum_cuda(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                     order: SegmentOrder | None = None) -> torch.Tensor:
    """Same function as ``ref.segment_sum_ref``: out[s] = sum_{i:
    segment_ids[i] = s} data[i], dense [num_segments, d] in data's dtype
    (f32 or bf16), summed in f32 in a fixed order (each segment's entries
    in their own order, chunk by chunk), by ``bag_backward.cu``'s gather
    entry with ``num_segments`` rows and one entry a bag: the gather
    transpose's sum, with ``data`` as its grad_out. That entry reads no
    table (the table is read only for d_w, not asked here), so none is
    passed and none is allocated. Segments no id names are exactly zero;
    ids in [0, num_segments) (not checked: that would need a host sync).
    With ``order`` (``segment_order_cuda(segment_ids, num_segments)``) it
    sorts nothing: one warp a split of whole rows writes each row, zero or
    summed. The same bits every call, with or without an order."""
    if data.dim() != 2 or data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("segment_sum takes [L, d] float32 or bfloat16 data")
    L, d = data.shape
    if segment_ids.dtype not in INDEX_DTYPES or segment_ids.shape != (L,):
        raise TypeError(f"segment_ids must be an [L] tensor of {INDEX_DTYPES}")
    if L >= 2**31 or num_segments >= 2**31 or num_segments < 0:
        raise ValueError("segment_sum counts entries and segments in 32 bits")
    ids = segment_ids.contiguous()
    g = data.to(torch.float32).contiguous()
    out = torch.empty((num_segments, d), dtype=data.dtype, device=data.device)
    if num_segments == 0 or d == 0:
        return out
    if order is None:
        _backward_launch(None, ids, None, g, None, False, L, out, None)
    else:
        _rows_launch(g, order, out)
    COUNTS["segment_sum"].kernel += 1
    return out
