"""ctypes wrapper of the hand-written CUDA ``bag`` kernel
(``repro_torch/csrc/bag.cu``): EmbeddingBag, one warp per bag over
entries sorted by bag."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import SMS
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
