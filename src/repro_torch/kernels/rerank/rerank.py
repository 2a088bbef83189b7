"""ctypes wrapper of the hand-written CUDA ``rerank`` kernel
(``repro_torch/csrc/rerank.cu``): exact top-k over each query's routed
ring buffers, one block per query.

The ring tensors may be strided views (``embs[:, :depth]`` for a
depth-clipped plan): their strides go to the kernel, and the store is
never copied."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import COUNTS


def _fn():
    lib = build.load("rerank")
    fn = lib.rerank_launch
    if fn.argtypes is None:
        P, I, L = build.P, build.I, build.L
        fn.argtypes = [P, I, I, P, I, I, P, I, L, L, P, L, L, P, L, L, I, I,
                       P, P, P]
        fn.restype = I
        lib.rerank_smem_bytes.argtypes = [I, I, I]
        lib.rerank_smem_bytes.restype = L
    return lib, fn


def rerank_topk_cuda(q: torch.Tensor, embs: torch.Tensor, live: torch.Tensor,
                     routes: torch.Tensor, k: int,
                     scales: torch.Tensor | None = None):
    """Same contract as ``ref.rerank_topk_ref``; all tensors on one CUDA
    device. q [Q, d] f32 and routes [Q, nprobe] i32 contiguous; embs
    [C, depth, d] / live / scales [C, depth] may be strided along their
    leading axes; their last axis must be dense."""
    Q, d = q.shape
    C, depth, _ = embs.shape
    nprobe = routes.shape[1]
    quantized = embs.dtype == torch.int8
    if (scales is not None) != quantized:
        raise ValueError("int8 rings need per-slot scales; fp32 rings none")
    if not quantized and embs.dtype != torch.float32:
        raise TypeError(f"ring dtype {embs.dtype}: fp32 or int8")
    if q.dtype != torch.float32 or routes.dtype != torch.int32:
        raise TypeError("q must be float32 and routes int32")
    if not (q.is_contiguous() and routes.is_contiguous()):
        raise ValueError("q and routes must be contiguous")
    if routes.shape[0] != Q or not 1 <= k <= nprobe * depth:
        raise ValueError("need routes [Q, nprobe] and 1 <= k <= nprobe*depth")
    if embs.shape[2] != d or embs.stride(2) != 1:
        raise ValueError("ring rows must be dense along d")
    if live.dtype != torch.bool or live.shape != (C, depth):
        raise TypeError("live must be a [C, depth] bool tensor")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.shape != (C, depth)):
        raise TypeError("scales must be a [C, depth] float32 tensor")
    dev = q.device
    scores = torch.empty((Q, k), dtype=torch.float32, device=dev)
    pos = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return scores, pos
    lib, fn = _fn()
    smem = lib.rerank_smem_bytes(d, nprobe, depth)
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"rerank kernel needs {smem} B of shared memory "
                         f"(d={d}, nprobe={nprobe}, depth={depth}), over the "
                         f"{build.SMEM_PER_BLOCK} B a block has")
    ss0, ss1 = (scales.stride(0), scales.stride(1)) if quantized else (0, 0)
    err = fn(q.data_ptr(), Q, d, routes.data_ptr(), nprobe, C, embs.data_ptr(),
             depth, embs.stride(0), embs.stride(1), live.data_ptr(),
             live.stride(0), live.stride(1), build.ptr(scales), ss0, ss1,
             int(quantized), k, scores.data_ptr(), pos.data_ptr(),
             build.stream_of(dev))
    build.check(lib, err, "rerank_launch")
    COUNTS["rerank"].kernel += 1
    return scores, pos
