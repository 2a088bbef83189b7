"""fm [recsys] — 39 sparse fields, embed_dim=10, pairwise interactions via
the O(nk) sum-square trick. [ICDM'10 (Rendle); paper]
"""
from repro_torch.configs.recsys_common import SMOKE_RS_SHAPES
from repro_torch.models.api import register
from repro_torch.models.recsys import FM, FMConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = FMConfig(
    name="fm",
    n_fields=39,
    embed_dim=10,
    rows_per_field=1_000_000,   # Criteo-scale hashed vocab per field
)

# the reference config's optimizer, kept for training (ROADMAP A10); serving reads none of it
OPT = OptimizerConfig(kind="adamw", lr=1e-3, clip_norm=1.0)


@register("fm")
def make(smoke: bool = False):
    if smoke:
        arch = FM(FMConfig(name="fm-smoke", n_fields=39, embed_dim=10,
                           rows_per_field=1000))
        arch.shapes = dict(SMOKE_RS_SHAPES)
        return arch
    return FM(CONFIG)
