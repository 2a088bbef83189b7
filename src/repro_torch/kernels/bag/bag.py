"""ctypes wrapper of the hand-written CUDA ``bag`` kernel
(``repro_torch/csrc/bag.cu``): EmbeddingBag, one warp per bag over
entries sorted by bag."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import COUNTS


def _fn():
    lib = build.load("bag")
    fn = lib.bag_launch
    if fn.argtypes is None:
        P, I = build.P, build.I
        fn.argtypes = [P, I, I, P, P, P, I, I, I, P, P]
        fn.restype = I
    return lib, fn


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       segment_ids: torch.Tensor, num_bags: int,
                       weights: torch.Tensor | None = None, mode: str = "sum"):
    """Same function as ``ref.embedding_bag_ref``; every tensor on one CUDA
    device. What the reference's wrapper does outside its ``pallas_call``
    happens here: weights default to ones, and a stable sort by bag (as
    ``jnp.argsort``) makes each bag's entries contiguous in their original
    order, which is the order the kernel sums them in."""
    L = indices.shape[0]
    if weights is None:
        weights = torch.ones((L,), dtype=torch.float32, device=table.device)
    order = torch.argsort(segment_ids, stable=True)
    return embedding_bag_sorted_cuda(table, indices[order].to(torch.int32),
                                     segment_ids[order].to(torch.int32),
                                     weights[order].to(torch.float32), num_bags, mode)


def embedding_bag_sorted_cuda(table: torch.Tensor, idx_s: torch.Tensor,
                              seg_s: torch.Tensor, w_s: torch.Tensor,
                              num_bags: int, mode: str = "sum"):
    """The launch alone: idx_s, seg_s [L] i32 sorted by bag (seg_s
    ascending, in [0, num_bags)), w_s [L] f32; table [V, d] f32 or bf16,
    contiguous, every index in [0, V) (the kernel does not check it)."""
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("bag kernel takes a [V, d] float32 or bfloat16 table")
    L = idx_s.shape[0]
    for name, t, dt in (("idx_s", idx_s, torch.int32), ("seg_s", seg_s, torch.int32),
                        ("w_s", w_s, torch.float32)):
        if t.dtype != dt or t.shape != (L,) or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous [L] {dt} tensor")
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
    err = fn(table.data_ptr(), int(table.dtype == torch.bfloat16), d, idx_s.data_ptr(),
             seg_s.data_ptr(), w_s.data_ptr(), L, num_bags, int(mode == "mean"),
             out.data_ptr(), build.stream_of(table.device))
    build.check(lib, err, "bag_launch")
    COUNTS["bag"].kernel += 1
    return out
