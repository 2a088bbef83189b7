"""Optimizers (no external deps): AdamW, Adafactor and SGD, with
global-norm clipping and a cosine LR schedule.

Formula for formula the reference's ``train/optimizer.py``, as plain
functions on tensors (not ``torch.optim``: its AdamW decays the params
before the step and rounds in another order). ``apply`` is functional:
it returns new tensors and writes none of its arguments, so a step that
fails half way leaves the live state as it was (the trainer's retry path
re-runs the step from it). Param trees are nested dicts of tensors;
leaves are visited in sorted key order, the reference's tree order.

AdamW keeps two fp32 moments per param; Adafactor's factored second
moment keeps a row and a column statistic per matrix whose last two
dims are both at least ``factored_min_dim``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"            # "adamw" | "adafactor" | "sgd"
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # Adafactor
    factored_min_dim: int = 128
    decay_rate: float = 0.8


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: Any              # AdamW m / None
    nu: Any              # AdamW v / Adafactor (row, col | full) / None


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts (the first tree's structure;
    tuples are leaves, as Adafactor's (row, col) pairs are to its rule)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> list:
    """Leaves of nested dicts in sorted key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, in float32 tensors."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    """Norm in fp32; grads keep their dtype."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
def _factored(shape, min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def _step_device(params):
    return leaves(params)[0].device


def init(cfg: OptimizerConfig, params) -> OptState:
    def zeros(shape, p):
        return torch.zeros(tuple(shape), dtype=torch.float32, device=p.device)

    if cfg.kind == "adamw":
        mu = tree_map(lambda p: zeros(p.shape, p), params)
        nu = tree_map(lambda p: zeros(p.shape, p), params)
    elif cfg.kind == "adafactor":
        mu = None

        def make_nu(p):
            if _factored(p.shape, cfg.factored_min_dim):
                return (zeros(p.shape[:-1], p),                           # row
                        zeros(tuple(p.shape[:-2]) + tuple(p.shape[-1:]), p))  # col
            return zeros(p.shape, p)

        nu = tree_map(make_nu, params)
    elif cfg.kind == "sgd":
        mu, nu = None, None
    else:
        raise ValueError(cfg.kind)
    step = torch.zeros((), dtype=torch.int32, device=_step_device(params))
    return OptState(step=step, mu=mu, nu=nu)


def apply(cfg: OptimizerConfig, params, grads, state: OptState):
    """One optimizer step. Returns (new_params, new_state, metrics); no
    argument is written."""
    metrics = {}
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gnorm

    step = state.step + 1
    lr = schedule(cfg, step)
    metrics["lr"] = lr

    if cfg.kind == "adamw":
        b1, b2 = cfg.betas
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

        def upd(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, OptState(step, mu, nu), metrics

    if cfg.kind == "adafactor":
        decay = 1.0 - (step.to(torch.float32) ** -cfg.decay_rate)

        def upd(p, v, g):
            g = g.to(torch.float32)  # per-leaf fp32 math (transient)
            g2 = g * g + 1e-30
            if isinstance(v, tuple):
                row, col = v
                row = decay * row + (1 - decay) * torch.mean(g2, dim=-1)
                col = decay * col + (1 - decay) * torch.mean(g2, dim=-2)
                row_mean = torch.mean(row, dim=-1, keepdim=True)
                vhat = (row[..., None] * col[..., None, :]
                        / torch.clamp(row_mean[..., None], min=1e-30))
                new_v = (row, col)
            else:
                vhat = decay * v + (1 - decay) * g2
                new_v = vhat
            u = g / torch.sqrt(vhat + 1e-30)
            # update clipping (Adafactor RMS rule)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms, min=1.0)
            u = u + cfg.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype), new_v

        outs = tree_map(upd, params, state.nu, grads)
        new_params = tree_map(lambda o: o[0], outs)
        new_nu = tree_map(lambda o: o[1], outs)
        return new_params, OptState(step, None, new_nu), metrics

    # sgd
    new_params = tree_map(
        lambda p, g: (p.to(torch.float32) - cfg.lr * g).to(p.dtype), params, grads)
    return new_params, OptState(step, None, None), metrics
