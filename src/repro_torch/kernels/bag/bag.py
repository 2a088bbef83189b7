"""ctypes wrappers of the hand-written CUDA ``bag`` kernels: EmbeddingBag
(``repro_torch/csrc/bag.cu``: one warp per bag over entries sorted by
bag) and its gradient (``repro_torch/csrc/bag_backward.cu``: runs of equal
row id summed in fixed chunks, then chunk partials in chunk order), whose
entry also takes a row gather's gradient (``gather_backward_cuda``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import SMS, cdiv
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


BWD_CHUNK = 256   # entries a warp sums per level of bag_backward.cu (its kChunk)


def _bwd_fn():
    lib = build.load("bag_backward")
    fn = lib.bag_backward_launch
    if fn.argtypes is None:
        P, I = build.P, build.I
        fn.argtypes = [P, I, I, P, I, P, P, P, I, P, P, P, I, P, P, P, P, P, P, P]
        fn.restype = I
    return lib, fn


def _backward_launch(table, indices, segment_ids, grad_out, weights, cnt, d_table, d_w):
    """Sort the entries by row (stable) and launch ``bag_backward.cu``
    (``segment_ids`` None: a gather's transpose, entry i is bag i)."""
    dev, d, L = table.device, table.shape[1], indices.shape[0]
    keys, perm = torch.sort(indices.to(torch.int32), stable=True)
    n1 = 2 * cdiv(L, BWD_CHUNK)
    n2 = 2 * cdiv(n1, BWD_CHUNK)
    keys_a = torch.empty((n1,), dtype=torch.int32, device=dev)
    vecs_a = torch.empty((n1, d), dtype=torch.float32, device=dev)
    keys_b = torch.empty((n2,), dtype=torch.int32, device=dev)
    vecs_b = torch.empty((n2, d), dtype=torch.float32, device=dev)
    lib, fn = _bwd_fn()
    err = fn(table.data_ptr(), int(table.dtype == torch.bfloat16), d, indices.data_ptr(),
             int(indices.dtype == torch.int64), keys.data_ptr(), perm.data_ptr(),
             build.ptr(segment_ids),
             int(segment_ids is not None and segment_ids.dtype == torch.int64),
             build.ptr(weights), build.ptr(cnt), grad_out.data_ptr(), L,
             d_table.data_ptr(), build.ptr(d_w), keys_a.data_ptr(), vecs_a.data_ptr(),
             keys_b.data_ptr(), vecs_b.data_ptr(), build.stream_of(dev))
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
    device, segment ids in any order. Around the launch: d_table is
    allocated by ``torch.zeros`` (the rows no entry touches), each bag's
    entry count (mean mode) is an ``index_add_`` of ones, and the entries
    are sorted by row id with a stable ``torch.sort`` (so each row keeps
    its entries' order). The result is the same bit for bit from call to
    call."""
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
    d_table = torch.zeros((V, d), dtype=table.dtype, device=dev)
    d_w = torch.zeros((L,), dtype=torch.float32, device=dev) if weights_grad else None
    if L == 0 or d == 0:
        return d_table, d_w
    cnt = None
    if mode == "mean":
        cnt = torch.zeros((num_bags,), dtype=torch.float32, device=dev).index_add_(
            0, segment_ids, torch.ones((1,), dtype=torch.float32, device=dev).expand(L))
        cnt = torch.clamp(cnt, min=1.0)
    _backward_launch(table, indices, segment_ids, grad_out, weights, cnt, d_table, d_w)
    COUNTS["bag_backward"].kernel += 1
    return d_table, d_w


def gather_backward_cuda(table: torch.Tensor, ids: torch.Tensor,
                         grad_out: torch.Tensor) -> torch.Tensor:
    """Same function as ``ref.gather_backward_ref``: the dense gradient of
    ``table[ids]`` ([V, d] in the table's dtype), by ``bag_backward.cu``
    with one entry a bag (no segments, every weight 1); ``grad_out``
    [*ids.shape, d], widened to f32. The same bits every call."""
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
    d_table = torch.zeros((V, d), dtype=table.dtype, device=table.device)
    if L == 0 or d == 0:
        return d_table
    _backward_launch(table, flat, None, g, None, None, d_table, None)
    COUNTS["gather_backward"].kernel += 1
    return d_table
