"""Shared smoke-shape machinery for the four recsys configs."""
from repro_torch.models.api import ShapeDef

SMOKE_RS_SHAPES = {
    "train_batch": ShapeDef("train_batch", "train", (("batch", 32),)),
    "serve_p99": ShapeDef("serve_p99", "serve", (("batch", 8),)),
    "serve_bulk": ShapeDef("serve_bulk", "serve", (("batch", 64),)),
    "retrieval_cand": ShapeDef("retrieval_cand", "retrieval",
                               (("batch", 1), ("n_candidates", 1000),)),
}
