"""Dispatcher for top-k MIPS: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_same_device
from repro_torch.kernels.mips.ref import mips_topk_ref


def mips_topk(q: torch.Tensor, index: torch.Tensor, valid: torch.Tensor,
              k: int):
    """Top-k inner-product search: (scores [Q, k] f32 desc, ids [Q, k] i32);
    invalid rows never surface ahead of valid ones, ties to the lowest
    row. For cosine retrieval pre-normalize q and index."""
    assert 1 <= k <= index.shape[0], "k must be in [1, N]"
    if check_same_device(q, index, valid).type == "cuda":
        from repro_torch.kernels.mips.mips import mips_topk_cuda

        return mips_topk_cuda(q, index, valid, k)
    return mips_topk_ref(q, index, valid, k)
