"""Dispatcher for fused ingest admission: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.admit.ref import admit_ref
from repro_torch.kernels.common import check_same_device


def admit(x: torch.Tensor, basis: torch.Tensor, centroids: torch.Tensor,
          alpha: float, live: torch.Tensor | None = None, *,
          store_dtype: str = "fp32", normalize: bool = True,
          emit_rows: bool = True):
    """One fused admission decision per row: returns ``(r [B] f32, keep
    [B] bool, labels [B] i32, sims [B] f32, v [B, d] f32|i8 | None,
    vscale [B] f32 | None)``."""
    kw = dict(store_dtype=store_dtype, normalize=normalize,
              emit_rows=emit_rows)
    if check_same_device(x, basis, centroids, live).type == "cuda":
        from repro_torch.kernels.admit.admit import admit_cuda

        return admit_cuda(x, basis, centroids, alpha, live, **kw)
    return admit_ref(x, basis, centroids, alpha, live, **kw)
