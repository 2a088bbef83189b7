"""meshgraphnet [gnn] — 15 layers, d_hidden=128, sum aggregator, 2-layer
MLPs. [arXiv:2010.03409; unverified]
"""
import dataclasses

from repro_torch.models.api import ShapeDef, register
from repro_torch.models.gnn import GNNConfig, MeshGraphNet
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = GNNConfig(
    name="meshgraphnet",
    n_layers=15,
    d_hidden=128,
    mlp_layers=2,
    aggregator="sum",
    remat=True,
)

OPT = OptimizerConfig(kind="adamw", lr=1e-3, clip_norm=1.0)

SMOKE_SHAPES = {
    "full_graph_sm": ShapeDef("full_graph_sm", "train",
                              (("n_nodes", 64), ("n_edges", 256),
                               ("d_feat", 16), ("n_out", 4))),
    "minibatch_lg": ShapeDef("minibatch_lg", "train",
                             (("n_nodes", 512), ("n_edges", 2048),
                              ("batch_nodes", 8), ("fanout1", 3),
                              ("fanout2", 2), ("d_feat", 16), ("n_out", 4),
                              ("pad_nodes", 96), ("pad_edges", 96))),
    "ogb_products": ShapeDef("ogb_products", "train",
                             (("n_nodes", 128), ("n_edges", 512),
                              ("d_feat", 16), ("n_out", 4))),
    "molecule": ShapeDef("molecule", "train",
                         (("n_nodes", 10), ("n_edges", 20), ("batch", 4),
                          ("d_feat", 8), ("n_out", 1))),
}


@register("meshgraphnet")
def make(smoke: bool = False):
    if smoke:
        arch = MeshGraphNet(
            dataclasses.replace(CONFIG, n_layers=2, d_hidden=16, remat=False),
            optimizer=OPT)
        arch.shapes = dict(SMOKE_SHAPES)
        arch.d_feat = max(s.dim("d_feat") for s in arch.shapes.values())
        arch.n_out = max(s.dim("n_out") for s in arch.shapes.values())
        return arch
    return MeshGraphNet(CONFIG, optimizer=OPT)
