"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) per-expert
d_ff=1408, vocab=102400, 2 shared + 64 routed top-6 fine-grained experts;
first layer dense (d_ff=10944). [arXiv:2401.06066; hf]

``fsdp`` maps the embed axis onto ``data`` in the specs
(``distributed/sharding.py``): the AdamW state of 16.4 B params does not
fit one card.
"""
import torch

from repro_torch.configs.lm_common import build
from repro_torch.models.api import register
from repro_torch.models.layers import MoEConfig
from repro_torch.models.transformer import LMConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = LMConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # MHA
    d_ff=1408,
    vocab=102400,
    moe=MoEConfig(
        num_experts=64,
        num_shared=2,
        top_k=6,
        d_model=2048,
        d_ff=1408,
        router="softmax_topk",
        capacity_factor=1.25,
        tokens_per_group=4096,
    ),
    first_k_dense=1,
    dense_ff=10944,
    rope_theta=10_000.0,
    attn_chunk=1024,
    remat=True,
    use_flash=True,
    train_microbatches=8,
    param_dtype=torch.bfloat16,
    act_dtype=torch.bfloat16,
    fsdp=True,
)

OPT = OptimizerConfig(kind="adamw", lr=2e-4, clip_norm=1.0)


@register("deepseek-moe-16b")
def make(smoke: bool = False):
    return build(CONFIG, OPT, smoke)
