"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; GQA with QKV bias, tied embeddings.
[arXiv:2407.10671; hf]

``shard_seq``: 12 heads do not divide a 16-wide model axis, so the specs
(``distributed/sharding.py``) leave the head dims replicated, and the
reference shards attention along the sequence by activation constraints
(``_constrain``), placement hints to XLA's partitioner with no effect in
one process and no counterpart here; no code of either package reads the
flag itself.
"""
import torch

from repro_torch.configs.lm_common import build
from repro_torch.models.api import register
from repro_torch.models.transformer import LMConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = LMConfig(
    name="qwen2-1.5b",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    tied_embeddings=True,
    window=None,            # full attention -> long_500k skipped
    rope_theta=1_000_000.0,
    attn_chunk=1024,
    remat=True,
    use_flash=True,
    param_dtype=torch.bfloat16,
    act_dtype=torch.bfloat16,
    train_microbatches=8,
    shard_seq=True,
)

OPT = OptimizerConfig(kind="adamw", lr=3e-4, clip_norm=1.0)


@register("qwen2-1.5b")
def make(smoke: bool = False):
    return build(CONFIG, OPT, smoke)
