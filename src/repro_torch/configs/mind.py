"""mind [recsys] — embed_dim=64, n_interests=4, capsule_iters=3,
multi-interest dynamic routing. [arXiv:1904.08030; unverified]
"""
from repro_torch.configs.recsys_common import SMOKE_RS_SHAPES
from repro_torch.models.api import register
from repro_torch.models.recsys import MIND, MINDConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = MINDConfig(
    name="mind",
    embed_dim=64,
    n_interests=4,
    capsule_iters=3,
    hist_len=50,
    n_items=1_000_000,
)

# the train step's optimizer, passed to the arch in both branches as the reference does
OPT = OptimizerConfig(kind="adamw", lr=1e-3, clip_norm=1.0)


@register("mind")
def make(smoke: bool = False):
    if smoke:
        arch = MIND(MINDConfig(name="mind-smoke", embed_dim=16, n_interests=2,
                               capsule_iters=2, hist_len=8, n_items=1000), optimizer=OPT)
        arch.shapes = dict(SMOKE_RS_SHAPES)
        return arch
    return MIND(CONFIG, optimizer=OPT)
