"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000; llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]
"""
import torch

from repro_torch.configs.lm_common import build
from repro_torch.models.api import register
from repro_torch.models.transformer import LMConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = LMConfig(
    name="h2o-danube-1.8b",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    window=4096,
    rope_theta=10_000.0,
    attn_chunk=1024,
    remat=True,
    use_flash=True,
    param_dtype=torch.bfloat16,
    act_dtype=torch.bfloat16,
    train_microbatches=8,
)

OPT = OptimizerConfig(kind="adamw", lr=3e-4, clip_norm=1.0)


@register("h2o-danube-1.8b")
def make(smoke: bool = False):
    return build(CONFIG, OPT, smoke)
