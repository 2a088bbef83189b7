"""Plain PyTorch version of fused ingest admission (Algorithm 1, steps
1-3): the staged composition of the mean-cosine screen
(``prefilter.ref.mean_cosine``), nearest-centroid assignment
(``assign.ref.nearest_centroid``) and quantize-on-admit
(``store.quant``), as the reference's ``kernels/admit/ref.py`` composes
them."""
from __future__ import annotations

import torch

from repro_torch.kernels.assign.ref import nearest_centroid
from repro_torch.kernels.common import l2_normalize
from repro_torch.kernels.counts import COUNTS
from repro_torch.kernels.prefilter.ref import mean_cosine
from repro_torch.store import quant


def admit_ref(x: torch.Tensor, basis: torch.Tensor, centroids: torch.Tensor,
              alpha: float, live: torch.Tensor | None = None, *,
              store_dtype: str = "fp32", normalize: bool = True,
              emit_rows: bool = True):
    """One admission decision per row of a microbatch.

    x [B, d]; basis [n, d]; centroids [K, d]; live [B] bool or None.
    Returns (r [B] f32, keep [B] bool = (r >= alpha) & live, labels [B]
    i32, sims [B] f32, v [B, d] f32|i8 or None, vscale [B] f32 or None).
    """
    COUNTS["admit"].plain += 1
    r = mean_cosine(x, basis)
    keep = r >= alpha
    if live is not None:
        keep = keep & live
    labels, sims = nearest_centroid(x, centroids)
    if not emit_rows:
        return r, keep, labels, sims, None, None
    v = l2_normalize(x) if normalize else x.to(torch.float32)
    if store_dtype == "int8":
        v, vscale = quant.quantize_int8(v, dim=-1)
    else:
        vscale = torch.ones((x.shape[0],), dtype=torch.float32,
                            device=x.device)
    return r, keep, labels, sims, v, vscale
