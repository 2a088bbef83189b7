"""ctypes wrapper of the hand-written CUDA ``prefilter`` kernel
(``repro_torch/csrc/prefilter.cu``): the mean-cosine screen, one warp
per row, after a small launch that normalizes the basis rows."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import COUNTS


def _fn():
    lib = build.load("prefilter")
    fn = lib.prefilter_launch
    if fn.argtypes is None:
        P, I = build.P, build.I
        fn.argtypes = [P, I, I, P, I, P, P, P]
        fn.restype = I
        lib.prefilter_smem_bytes.argtypes = [I]
        lib.prefilter_smem_bytes.restype = build.L
    return lib, fn


def prefilter_scores_cuda(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Same function as ``ref.prefilter_scores_ref`` under the TPU
    kernel's contract (rsqrt-normalized rows); both tensors on one CUDA
    device. The basis is normalized once per call, in the kernel's first
    launch, as ``normalize_basis_rows`` computes it (the TPU kernel's
    wrapper does that step before its kernel)."""
    B, d = x.shape
    n = basis.shape[0]
    if basis.shape[1] != d or n == 0:
        raise ValueError("x [B, d] and a basis [n >= 1, d] must share d")
    x32 = x.to(torch.float32).contiguous()
    v32 = basis.to(torch.float32).contiguous()
    vn = torch.empty_like(v32)
    r = torch.empty((B,), dtype=torch.float32, device=x.device)
    if B == 0:
        return r
    lib, fn = _fn()
    smem = lib.prefilter_smem_bytes(d)
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"prefilter kernel needs {smem} B of shared memory "
                         f"for d={d}; a block has {build.SMEM_PER_BLOCK} B")
    err = fn(x32.data_ptr(), B, d, v32.data_ptr(), n, vn.data_ptr(), r.data_ptr(),
             build.stream_of(x.device))
    build.check(lib, err, "prefilter_launch")
    COUNTS["prefilter"].kernel += 1
    return r
