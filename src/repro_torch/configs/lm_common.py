"""Shared helpers for the LM configs: the smoke shapes and the reduced
same-family config."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.api import ShapeDef
from repro_torch.models.transformer import LMConfig, TransformerLM
from repro_torch.train.optimizer import OptimizerConfig

SMOKE_LM_SHAPES = {
    "train_4k": ShapeDef("train_4k", "train", (("seq", 64), ("batch", 2))),
    "prefill_32k": ShapeDef("prefill_32k", "prefill", (("seq", 64), ("batch", 2))),
    "decode_32k": ShapeDef("decode_32k", "decode", (("seq", 128), ("batch", 2))),
    "long_500k": ShapeDef("long_500k", "decode", (("seq", 256), ("batch", 1))),
}


def smoke_lm(cfg: LMConfig, window: int | None = None) -> LMConfig:
    """Reduced same-family config: tiny widths, few layers, same structure."""
    kw = dict(
        n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4),
        d_ff=128, vocab=512, remat=False, attn_chunk=32,
        param_dtype=torch.float32, act_dtype=torch.float32,
        window=window if cfg.window else None,
        train_microbatches=2,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_model=64, d_ff=32,
            tokens_per_group=64, capacity_factor=4.0)
        kw["first_k_dense"] = min(cfg.first_k_dense, 1)
        kw["dense_ff"] = 128
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)


def build(cfg: LMConfig, opt: OptimizerConfig, smoke: bool) -> TransformerLM:
    if smoke:
        arch = TransformerLM(smoke_lm(cfg, window=16), optimizer=opt)
        skip = {n: s.skip for n, s in arch.shapes.items()}
        arch.shapes = {n: dataclasses.replace(s, skip=skip.get(n))
                       for n, s in SMOKE_LM_SHAPES.items()}
        return arch
    return TransformerLM(cfg, optimizer=opt)
