"""Dispatcher for the heavy-hitter counter's batch update: a CPU tensor
runs the plain version, a CUDA tensor launches the kernel, a ``meta``
tensor gets the outputs' shapes and dtypes, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.core import heavy_hitter as hh
from repro_torch.kernels import cost
from repro_torch.kernels.common import check_same_device
from repro_torch.kernels.heavy_hitter import ref


def _meta(state, labels):
    B, dev = labels.shape[0], labels.device
    new = type(state)(*(torch.empty_like(t) for t in state))
    flag = torch.empty((B,), dtype=torch.bool, device=dev)
    i32 = torch.empty((B,), dtype=torch.int32, device=dev)
    return new, {"admitted": flag, "hit": torch.empty_like(flag),
                 "evicted_label": i32, "slot": torch.empty_like(i32)}


def _work(cfg, state, labels, out) -> cost.Work:
    counting = cfg.policy == hh.Policy.COUNT_MIN
    evicting = 0
    if not labels.is_meta:
        evicting = int(out[0].total_evictions) - int(state.total_evictions)
    return cost.heavy_hitter(labels.shape[0], state.labels.shape[0],
                             cfg.cms_depth * cfg.cms_width if counting else 0,
                             cfg.morris, cfg.policy == hh.Policy.RANDOM_EVICT, evicting)


def update_batch(cfg, state, labels: torch.Tensor, draws: dict):
    """The per-arrival update of ``state`` over ``labels`` [B] i32 (−1
    dropped) with the given draws; see ``ref.update_batch_ref``."""
    dev = check_same_device(labels, state.labels, *draws.values())

    def run():
        if dev.type == "cuda":
            from repro_torch.kernels.heavy_hitter.heavy_hitter import update_batch_cuda

            return update_batch_cuda(cfg, state, labels, draws)
        if dev.type == "meta":
            return _meta(state, labels)
        return ref.update_batch_ref(cfg, state, labels, draws)

    return cost.entry("heavy_hitter", run, lambda out: _work(cfg, state, labels, out))
