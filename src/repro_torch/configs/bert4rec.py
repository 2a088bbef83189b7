"""bert4rec [recsys] — embed_dim=64, 2 blocks, 2 heads, seq_len=200,
bidirectional cloze objective. [arXiv:1904.06690; paper]
"""
from repro_torch.configs.recsys_common import SMOKE_RS_SHAPES
from repro_torch.models.api import register
from repro_torch.models.recsys import BERT4Rec, BERT4RecConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = BERT4RecConfig(
    name="bert4rec",
    embed_dim=64,
    n_blocks=2,
    n_heads=2,
    seq_len=200,
    n_items=1_000_000,
)

# the train step's optimizer, passed to the arch in both branches as the reference does
OPT = OptimizerConfig(kind="adamw", lr=1e-3, clip_norm=1.0)


@register("bert4rec")
def make(smoke: bool = False):
    if smoke:
        arch = BERT4Rec(BERT4RecConfig(name="bert4rec-smoke", embed_dim=16,
                                       n_blocks=1, n_heads=2, seq_len=8,
                                       n_items=1000), optimizer=OPT)
        arch.shapes = dict(SMOKE_RS_SHAPES)
        return arch
    return BERT4Rec(CONFIG, optimizer=OPT)
