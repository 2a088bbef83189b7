"""dien [recsys] — embed_dim=18, seq_len=100, gru_dim=108, MLP 200-80,
AUGRU interest evolution. [arXiv:1809.03672; unverified]
"""
from repro_torch.configs.recsys_common import SMOKE_RS_SHAPES
from repro_torch.models.api import register
from repro_torch.models.recsys import DIEN, DIENConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = DIENConfig(
    name="dien",
    embed_dim=18,
    seq_len=100,
    gru_dim=108,
    mlp_dims=(200, 80),
    n_items=1_000_000,
)

# the reference config's optimizer, kept for training (ROADMAP A10); serving reads none of it
OPT = OptimizerConfig(kind="adamw", lr=1e-3, clip_norm=1.0)


@register("dien")
def make(smoke: bool = False):
    if smoke:
        arch = DIEN(DIENConfig(name="dien-smoke", embed_dim=8, seq_len=8,
                               gru_dim=16, mlp_dims=(16, 8), n_items=1000))
        arch.shapes = dict(SMOKE_RS_SHAPES)
        return arch
    return DIEN(CONFIG)
