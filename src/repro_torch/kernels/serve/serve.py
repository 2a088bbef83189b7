"""ctypes wrapper of the hand-written CUDA ``serve`` kernel
(``repro_torch/csrc/serve.cu``): the two-stage query in one launch.

The ring tensors may be strided views (``embs[:, :depth]`` for a
depth-clipped plan): their strides go to the kernel, and the store is
never copied."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import COUNTS

def _fn():
    lib = build.load("serve")
    fn = lib.serve_launch
    if fn.argtypes is None:
        P, I, L = build.P, build.I, build.L
        fn.argtypes = [P, P, I, I, P, I, P, P, P, I, L, L, P, L, L, P, L, L,
                       I, I, I, I, P, P, P, P, P, P]
        fn.restype = I
        lib.serve_smem_bytes.argtypes = [I, I, I, I, I]
        lib.serve_smem_bytes.restype = L
        lib.serve_rows_per_block.argtypes = [I, I, I]
        lib.serve_rows_per_block.restype = I
    return lib, fn


def serve_topk_cuda(qr: torch.Tensor, qn: torch.Tensor, vectors: torch.Tensor,
                    valid: torch.Tensor, route_labels: torch.Tensor,
                    embs: torch.Tensor, live: torch.Tensor, k: int,
                    nprobe: int, scales: torch.Tensor | None = None):
    """Same contract as ``ref.serve_topk_ref``; all tensors on one CUDA
    device. embs [C, depth, d] / live / scales [C, depth] may be strided
    along their leading axes; their last axis must be dense."""
    Q, d = qr.shape
    cap = vectors.shape[0]
    C, depth, _ = embs.shape
    quantized = embs.dtype == torch.int8
    if (scales is not None) != quantized:
        raise ValueError("int8 rings need per-slot scales; fp32 rings none")
    if not quantized and embs.dtype != torch.float32:
        raise TypeError(f"ring dtype {embs.dtype}: fp32 or int8")
    if not 1 <= k <= nprobe * depth or not 1 <= nprobe <= cap:
        raise ValueError("need 1 <= k <= nprobe*depth and nprobe <= cap")
    if embs.shape[2] != d or embs.stride(2) != 1:
        raise ValueError("ring rows must be dense along d")
    if live.dtype != torch.bool or live.shape != (C, depth):
        raise TypeError("live must be a [C, depth] bool tensor")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.shape != (C, depth)):
        raise TypeError("scales must be a [C, depth] float32 tensor")
    for t in (qr, qn, vectors, valid, route_labels):
        if not t.is_contiguous():
            raise ValueError("queries and index must be contiguous")
    if route_labels.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("route_labels i32 and valid bool")
    dev = qr.device
    scores = torch.empty((Q, k), dtype=torch.float32, device=dev)
    pos = torch.empty((Q, k), dtype=torch.int32, device=dev)
    routes = torch.empty((Q, nprobe), dtype=torch.int32, device=dev)
    if Q == 0:
        return scores, pos, routes
    lib, fn = _fn()
    smem = lib.serve_smem_bytes(d, cap, Q, nprobe, depth)
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"serve kernel needs {smem} B of shared memory "
                         f"(d={d}, nprobe={nprobe}, depth={depth}), over the "
                         f"{build.SMEM_PER_BLOCK} B a block has")
    # route survivors of each index chunk: [Q, chunks * nprobe]
    bn = lib.serve_rows_per_block(cap, Q, nprobe)
    m = -(-cap // bn) * nprobe
    part_val = torch.empty((Q, m), dtype=torch.float32, device=dev)
    part_idx = torch.empty((Q, m), dtype=torch.int32, device=dev)
    ss0, ss1 = (scales.stride(0), scales.stride(1)) if quantized else (0, 0)
    err = fn(qr.data_ptr(), qn.data_ptr(), Q, d, vectors.data_ptr(), cap,
             valid.data_ptr(), route_labels.data_ptr(), embs.data_ptr(), depth,
             embs.stride(0), embs.stride(1), live.data_ptr(), live.stride(0),
             live.stride(1), build.ptr(scales), ss0, ss1, int(quantized), k,
             nprobe, bn, part_val.data_ptr(), part_idx.data_ptr(),
             scores.data_ptr(), pos.data_ptr(), routes.data_ptr(),
             build.stream_of(dev))
    build.check(lib, err, "serve_launch")
    COUNTS["serve"].kernel += 1
    return scores, pos, routes
