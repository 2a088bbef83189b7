"""Plain PyTorch version of the ``heavy_hitter`` kernel: the counter's
per-arrival update over a microbatch as a Python loop of tensor ops
(``core.heavy_hitter.update_one`` per arrival, in order), with no host
reads."""
from __future__ import annotations

import torch

from repro_torch.core import heavy_hitter as hh
from repro_torch.kernels.counts import COUNTS


def update_batch_ref(cfg: "hh.HHConfig", state: "hh.HHState",
                     labels: torch.Tensor, draws: dict):
    """labels [B] i32 (−1 dropped); ``draws`` = {"uniforms": [B],
    "gumbel": [B, bmax], "morris": [B]} (the last two where the config
    uses them). Returns (new_state, info dict of [B] tensors)."""
    COUNTS["heavy_hitter"].plain += 1
    uniforms = draws["uniforms"].to(torch.float32)
    gumbel, morris_u = draws.get("gumbel"), draws.get("morris")
    slot_ids = torch.arange(state.labels.shape[0], device=labels.device)
    infos = []
    for i in range(labels.shape[0]):
        state, info = hh.update_one(
            cfg, state, labels[i], uniforms[i],
            None if gumbel is None else gumbel[i],
            None if morris_u is None else morris_u[i], slot_ids)
        infos.append(info)
    if not infos:
        empty = torch.zeros((0,), dtype=torch.int32, device=labels.device)
        return state, {"admitted": empty.bool(), "hit": empty.bool(),
                       "evicted_label": empty, "slot": empty}
    out = {name: torch.stack([inf[name] for inf in infos])
           for name in infos[0]}
    out["evicted_label"] = out["evicted_label"].to(torch.int32)
    out["slot"] = out["slot"].to(torch.int32)
    return state, out
