"""Optimizer settings carried by the architecture configs.

Only ``OptimizerConfig`` is ported: the serving path reads none of it.
The update rules (AdamW, Adafactor, clipping, the schedule) come with
training (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses


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
