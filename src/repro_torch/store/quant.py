"""Symmetric int8 quantization — the store's one rounding/scale rule.

    scale = max(max|x|, 1e-12) / 127
    q     = clip(round(x / scale), -127, 127)   as int8
    x̂     = q * scale

It divides by the scale (never multiplies by a reciprocal), and
``torch.round`` is round-half-to-even, like ``jnp.round``, so rows and
scales are bit-identical to the reference on the same fp32 input.
"""
from __future__ import annotations

import torch

QMAX = 127.0


def int8_scale(x: torch.Tensor, dim=None) -> torch.Tensor:
    x32 = x.to(torch.float32)
    amax = torch.amax(torch.abs(x32)) if dim is None else \
        torch.amax(torch.abs(x32), dim=dim)
    return torch.clamp(amax, min=1e-12) / QMAX


def quantize_int8(x: torch.Tensor, dim=None):
    """Returns ``(q int8, scale f32)``: one scale for the whole tensor
    (``dim=None``) or one per remaining index (``dim=-1``: per row)."""
    x32 = x.to(torch.float32)
    scale = int8_scale(x32, dim=dim)
    s = scale if dim is None else scale.unsqueeze(dim)
    q = torch.clamp(torch.round(x32 / s), -QMAX, QMAX).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
