"""Gradient / merge-payload compression: int8 all-reduce with error feedback.

1-bit-Adam-style EF: each shard keeps a residual e_t; the quantized value is
q(g + e_t), and e_{t+1} = (g + e_t) - dequant(q). Unbiased over time, 4x
less collective traffic for fp32 grads (8x under the inter-pod-only mode:
intra-pod reduces run full precision, only the slow inter-pod hop is
quantized; see ``collectives.hierarchical_psum``).

The int8 rounding/scale convention is the shared one in ``store.quant``
(the one the quantized document store uses), applied per tensor here.

As ``distributed.collectives``, over per-shard lists: one process holds
every shard's part, and the all-gather of the int8 payloads and their
scales is a ``.to(device)`` of each in shard order. As in the reference,
no training step calls these: they are library functions.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.store.quant import dequantize_int8, quantize_int8
from repro_torch.train.optimizer import tree_map


class EFState(NamedTuple):
    error: Any  # tree matching grads


def init_ef(grads_like) -> EFState:
    """Zero fp32 residuals shaped as ``grads_like``, on each leaf's device."""
    return EFState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def quantize_part(x: torch.Tensor, ef_error: torch.Tensor):
    """One shard's side: ``y = x + e`` quantized per tensor; returns
    ``(q int8, scale f32 0-d, new_error = y - dequant(q))``."""
    y = x.to(torch.float32) + ef_error
    q, scale = quantize_int8(y)
    return q, scale, y - dequantize_int8(q, scale)


def compressed_psum(parts: list[torch.Tensor], errors: list[torch.Tensor],
                    device) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Int8 all-reduce with error feedback over the shards' ``parts`` and
    residuals ``errors``: each shard's int8 payload and scalar scale are
    gathered onto ``device`` and summed dequantized, ``sum_i scale_i * q_i``
    in shard order. Returns (the total on ``device``, each shard's new
    residual on its own device)."""
    total, new_errors = None, []
    for x, e in zip(parts, errors, strict=True):
        q, scale, ne = quantize_part(x, e)
        new_errors.append(ne)
        term = scale.to(device) * q.to(device).to(torch.float32)
        total = term if total is None else total + term
    return total, new_errors


def compressed_grad_allreduce(grads: list, efs: list[EFState],
                              device) -> tuple[Any, list[EFState]]:
    """``compressed_psum`` leaf by leaf over the shards' gradient trees
    (nested dicts). Returns (the total tree on ``device``, each shard's new
    ``EFState``)."""
    n = len(grads)
    pairs = tree_map(lambda *xs: compressed_psum(list(xs[:n]), list(xs[n:]), device),
                     *grads, *(ef.error for ef in efs))
    return (tree_map(lambda pr: pr[0], pairs),
            [EFState(error=tree_map(lambda pr, s=s: pr[1][s], pairs)) for s in range(n)])
