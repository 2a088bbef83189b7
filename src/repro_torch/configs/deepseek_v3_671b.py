"""deepseek-v3-671b [moe] — 61L d_model=7168 128H, MLA (q_lora=1536,
kv_lora=512, qk_nope=128, qk_rope=64, v_head=128), 1 shared + 256 routed
top-8 experts (d_ff=2048), vocab=129280, MTP; first 3 layers dense
(d_ff=18432). [arXiv:2412.19437; hf]

Scale: bf16 params + Adafactor (factored second moment) + FSDP over the
data axis — AdamW fp32 state alone (8 B/param) would need 5.4 TB. ``fsdp``
maps the embed axis onto ``data`` in the specs (``distributed/sharding.py``);
one card holds the full-width model only cut in depth.
"""
import torch

from repro_torch.configs.lm_common import build
from repro_torch.models.api import register
from repro_torch.models.layers import MLAConfig, MoEConfig
from repro_torch.models.transformer import LMConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab=129280,
    mla=MLAConfig(
        d_model=7168,
        n_heads=128,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        num_shared=1,
        top_k=8,
        d_model=7168,
        d_ff=2048,
        router="sigmoid_norm",     # aux-loss-free bias routing
        capacity_factor=1.25,
        tokens_per_group=4096,
        route_scale=2.5,
    ),
    first_k_dense=3,
    dense_ff=18432,
    mtp=True,
    rope_theta=10_000.0,
    attn_chunk=512,
    remat=True,
    use_flash=True,
    train_microbatches=8,
    param_dtype=torch.bfloat16,
    act_dtype=torch.bfloat16,
    fsdp=True,
)

OPT = OptimizerConfig(kind="adafactor", lr=2.2e-4, clip_norm=1.0)


@register("deepseek-v3-671b")
def make(smoke: bool = False):
    return build(CONFIG, OPT, smoke)
