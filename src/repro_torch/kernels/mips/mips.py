"""ctypes wrapper of the hand-written CUDA ``mips`` kernel
(``repro_torch/csrc/mips.cu``): top-k inner products for any N."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import COUNTS

def _fn():
    lib = build.load("mips")
    fn = lib.mips_launch
    if fn.argtypes is None:
        P, I = build.P, build.I
        fn.argtypes = [P, I, I, P, I, P, I, I, P, P, P, P, P]
        fn.restype = I
        lib.mips_rows_per_block.argtypes = [I, I, I]
        lib.mips_rows_per_block.restype = I
        lib.mips_smem_bytes.argtypes = [I, I, I, I]
        lib.mips_smem_bytes.restype = build.L
    return lib, fn


def mips_topk_cuda(q: torch.Tensor, index: torch.Tensor, valid: torch.Tensor,
                   k: int):
    """q [Q, d] f32, index [N, d] f32, valid [N] bool, all contiguous on
    one CUDA device -> (scores [Q, k] f32, ids [Q, k] i32)."""
    Q, d = q.shape
    N = index.shape[0]
    if q.dtype != torch.float32 or index.dtype != torch.float32:
        raise TypeError("mips kernel takes float32 queries and index")
    if valid.dtype != torch.bool or valid.shape != (N,):
        raise TypeError("valid must be a [N] bool tensor")
    if index.shape[1] != d or not (q.is_contiguous() and index.is_contiguous()
                                   and valid.is_contiguous()):
        raise ValueError("mips kernel takes contiguous [Q, d] and [N, d]")
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must be in [1, N={N}]")
    dev = q.device
    scores = torch.empty((Q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return scores, ids
    lib, fn = _fn()
    smem = lib.mips_smem_bytes(d, N, Q, k)
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"mips kernel needs {smem} B of shared memory for "
                         f"k={k}, d={d}; a block has {build.SMEM_PER_BLOCK} B")
    bn = lib.mips_rows_per_block(N, Q, k)
    m = -(-N // bn) * k
    part_val = torch.empty((Q, m), dtype=torch.float32, device=dev)
    part_idx = torch.empty((Q, m), dtype=torch.int32, device=dev)
    err = fn(q.data_ptr(), Q, d, index.data_ptr(), N, valid.data_ptr(), k, bn,
             part_val.data_ptr(), part_idx.data_ptr(), scores.data_ptr(),
             ids.data_ptr(), build.stream_of(dev))
    build.check(lib, err, "mips_launch")
    COUNTS["mips"].kernel += 1
    return scores, ids
