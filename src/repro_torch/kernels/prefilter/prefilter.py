"""ctypes wrapper of the hand-written CUDA ``prefilter`` kernel
(``repro_torch/csrc/prefilter.cu``): the mean-cosine screen in one
launch, one warp per row, each block normalizing the basis for itself."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.counts import COUNTS

# rows (warps) a block takes: 8 (32 blocks at B = 256) timed fastest of 2, 4,
# 8 and 16 on an H100 80GB HBM3 at 700 W (PERF.md, prefilter)
PREFILTER_ROWS = 8


@dataclasses.dataclass(frozen=True)
class PrefilterPlan:
    rows: int     # rows of x a block takes, one warp each
    blocks: int
    smem: int     # bytes: the n unit basis rows every block holds


def prefilter_plan(B: int, n: int, d: int) -> PrefilterPlan:
    """Raises ``ValueError`` where the n x d basis does not fit one
    block's shared memory."""
    smem = 4 * n * d
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"prefilter kernel holds the {n} x {d} basis in {smem} B "
                         f"of shared memory; a block has {build.SMEM_PER_BLOCK} B")
    return PrefilterPlan(rows=PREFILTER_ROWS, blocks=cdiv(B, PREFILTER_ROWS), smem=smem)


def _fn():
    lib = build.load("prefilter")
    fn = lib.prefilter_launch
    if fn.argtypes is None:
        P, I = build.P, build.I
        fn.argtypes = [P, I, I, P, I, P, I, I, build.L, P]
        fn.restype = I
    return lib, fn


def prefilter_scores_cuda(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Same function as ``ref.prefilter_scores_ref`` under the TPU
    kernel's contract (rsqrt-normalized rows); both tensors on one CUDA
    device. The basis goes to the kernel raw: every block normalizes it
    as ``normalize_basis_rows`` computes it (the TPU kernel's wrapper does
    that step before its kernel)."""
    B, d = x.shape
    n = basis.shape[0]
    if basis.shape[1] != d or n == 0:
        raise ValueError("x [B, d] and a basis [n >= 1, d] must share d")
    plan = prefilter_plan(B, n, d)
    x32 = x.to(torch.float32).contiguous()
    v32 = basis.to(torch.float32).contiguous()
    r = torch.empty((B,), dtype=torch.float32, device=x.device)
    if B == 0:
        return r
    lib, fn = _fn()
    err = fn(x32.data_ptr(), B, d, v32.data_ptr(), n, r.data_ptr(), plan.rows,
             plan.blocks, plan.smem, build.stream_of(x.device))
    build.check(lib, err, "prefilter_launch")
    COUNTS["prefilter"].kernel += 1
    return r
