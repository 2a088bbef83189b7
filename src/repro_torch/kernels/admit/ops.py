"""Dispatcher for fused ingest admission: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel, a ``meta`` tensor gets the
outputs' shapes and dtypes, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.admit.ref import admit_ref
from repro_torch.kernels.common import check_same_device


def _meta(x, store_dtype, emit_rows):
    B, d = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    out = (torch.empty((B,), **f32), torch.empty((B,), dtype=torch.bool, device=x.device),
           torch.empty((B,), dtype=torch.int32, device=x.device), torch.empty((B,), **f32))
    if not emit_rows:
        return (*out, None, None)
    row = torch.int8 if store_dtype == "int8" else torch.float32
    return (*out, torch.empty((B, d), dtype=row, device=x.device), torch.empty((B,), **f32))


def admit(x: torch.Tensor, basis: torch.Tensor, centroids: torch.Tensor,
          alpha: float, live: torch.Tensor | None = None, *,
          store_dtype: str = "fp32", normalize: bool = True,
          emit_rows: bool = True):
    """One fused admission decision per row: returns ``(r [B] f32, keep
    [B] bool, labels [B] i32, sims [B] f32, v [B, d] f32|i8 | None,
    vscale [B] f32 | None)``."""
    kw = dict(store_dtype=store_dtype, normalize=normalize,
              emit_rows=emit_rows)
    dev = check_same_device(x, basis, centroids, live)

    def run():
        if dev.type == "cuda":
            from repro_torch.kernels.admit.admit import admit_cuda

            return admit_cuda(x, basis, centroids, alpha, live, **kw)
        if dev.type == "meta":
            return _meta(x, store_dtype, emit_rows)
        return admit_ref(x, basis, centroids, alpha, live, **kw)

    B, d = x.shape
    return cost.entry("admit", run, lambda out: cost.admit(
        B, d, centroids.shape[0], basis.shape[0], store_dtype == "int8",
        live=live is not None, emit_rows=emit_rows))
