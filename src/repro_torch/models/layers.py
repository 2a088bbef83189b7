"""Shared model-building blocks, as far as recsys serving needs them.

Parameters are plain nested dicts of tensors. ``Builder`` draws them from
one explicit ``torch.Generator`` with the reference's shapes and stddev
rule; the values differ from the reference's (another generator), so the
tests carry the reference's params across with ``convert``.
"""
from __future__ import annotations

import math
from typing import Any

import torch

Params = dict[str, Any]


class Builder:
    """Collects params drawn from one generator on one device."""

    def __init__(self, gen: torch.Generator, param_dtype=torch.float32):
        self.gen = gen
        self.device = gen.device
        self.dtype = param_dtype
        self.params: Params = {}

    def normal(self, name: str, shape, stddev: float | None = None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = stddev if stddev is not None else 1.0 / math.sqrt(fan_in)
        self.params[name] = (torch.randn(tuple(shape), generator=self.gen,
                                         device=self.device, dtype=torch.float32)
                             * std).to(self.dtype)
        return self

    def zeros(self, name: str, shape):
        self.params[name] = torch.zeros(tuple(shape), dtype=self.dtype,
                                        device=self.device)
        return self

    def ones(self, name: str, shape):
        self.params[name] = torch.ones(tuple(shape), dtype=self.dtype,
                                       device=self.device)
        return self

    def sub(self, name: str, params: Params):
        self.params[name] = params
        return self

    def build(self) -> Params:
        return self.params


def stack_layers(gen: torch.Generator, n_layers: int, make_one) -> Params:
    """n identical layers' params stacked on a leading layer axis, as the
    reference's scanned blocks. ``make_one(gen) -> params``."""
    layers = [make_one(gen) for _ in range(n_layers)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return stack(layers)


def layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of stacked params."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm forward: math in fp32, output in the input dtype."""
    x32 = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * r * scale.to(torch.float32)).to(x.dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype) -> Params:
    b = Builder(gen, dtype)
    b.normal("w_gate", (d_model, d_ff))
    b.normal("w_up", (d_model, d_ff))
    b.normal("w_down", (d_ff, d_model))
    return b.build()


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SiLU-gated MLP (SwiGLU family)."""
    h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
