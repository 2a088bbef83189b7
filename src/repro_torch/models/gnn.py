"""MeshGraphNet (Pfaff et al., arXiv:2010.03409): encode-process-decode GNN.

Message passing is a scatter/gather: edge messages are gathered per
edge endpoint (``kernels/bag/ops.gather_rows``: ``hn[ids]`` whose
gradient is the ``gather_backward`` kernel) and summed into destination
nodes (``kernels/bag/ops.segment_sum``: the same kernel's sum run
forward, the reference's ``jax.ops.segment_sum``). Both are deterministic
on the card, so a train step gives the same bits from call to call. The
forward sorts ``edge_dst`` and ``edge_src`` once each
(``ops.segment_order``) and hands the orders to every layer's sum and
gathers and to their recompute under remat: two sorts a step, where each
of a step's 60 sums would otherwise sort its ids again. All
four assigned graph shapes run through the same step with padded (node,
edge) buffers + masks:

  full_graph_sm  — 2,708 nodes / 10,556 edges / 1,433 feats (full batch)
  minibatch_lg   — 232,965 nodes / 114.6M edges; sampled batch 1,024,
                   fanout 15·10 (the sampler below builds the subgraph)
  ogb_products   — 2,449,029 nodes / 61.8M edges (full-batch large)
  molecule       — 30-node molecules, batch 128 (flattened disjoint union)

Processor = 15 residual message-passing layers (d_hidden=128, sum
aggregator, 2-layer MLPs with LayerNorm), a loop over stacked per-layer
params (the reference's ``lax.scan``), each layer under
``torch.utils.checkpoint`` when ``remat`` is on and a gradient is being
taken (the reference's ``jax.checkpoint``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.bag.ops import gather_rows, segment_order, segment_sum
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.api import Arch, ShapeDef, StepSpec, spec
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    aggregator: str = "sum"
    d_edge_feat: int = 4
    param_dtype: torch.dtype = torch.float32
    remat: bool = True


GNN_SHAPES = {
    "full_graph_sm": ShapeDef(
        "full_graph_sm", "train",
        (("n_nodes", 2708), ("n_edges", 10556), ("d_feat", 1433),
         ("n_out", 7))),
    "minibatch_lg": ShapeDef(
        "minibatch_lg", "train",
        (("n_nodes", 232965), ("n_edges", 114615892), ("batch_nodes", 1024),
         ("fanout1", 15), ("fanout2", 10), ("d_feat", 602), ("n_out", 41),
         # padded subgraph buffers: 1024·(1+15+150) nodes, 1024·(15+150) edges
         ("pad_nodes", 169984), ("pad_edges", 168960))),
    "ogb_products": ShapeDef(
        "ogb_products", "train",
        (("n_nodes", 2449029), ("n_edges", 61859140), ("d_feat", 100),
         ("n_out", 47))),
    "molecule": ShapeDef(
        "molecule", "train",
        (("n_nodes", 30), ("n_edges", 64), ("batch", 128), ("d_feat", 16),
         ("n_out", 1))),
}

PAD_TO = 512


def _init_mlp_stack(gen, d_in, d_hidden, d_out, n_hidden, dtype, norm=True):
    """MLP with n_hidden hidden layers + optional final LayerNorm (MGN style)."""
    b = L.Builder(gen, dtype)
    dims = [d_in] + [d_hidden] * n_hidden + [d_out]
    for i in range(len(dims) - 1):
        b.normal(f"w{i}", (dims[i], dims[i + 1]), ("gnn_in", "gnn_out"))
        b.zeros(f"b{i}", (dims[i + 1],), ("gnn_out",))
    if norm:
        b.ones("ln_scale", (d_out,), ("gnn_out",))
        b.zeros("ln_bias", (d_out,), ("gnn_out",))
    return b.build()


def _mlp_apply(p, x, n_layers):
    for i in range(n_layers + 1):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n_layers:
            x = torch.relu(x)
    if "ln_scale" in p:
        x = L.layer_norm(x, p["ln_scale"], p["ln_bias"])
    return x


def _mp_layer(p, hn, he, src, dst, emask, mlp_layers, src_order=None, dst_order=None):
    """One residual message-passing layer: (hn', he'). ``src_order`` and
    ``dst_order``: ``segment_order`` of ``src`` and ``dst`` over the nodes
    (None: each sum sorts its own ids)."""
    # edge update: m_ij = MLP([e_ij, h_src, h_dst]) + e_ij
    msg_in = torch.cat([he, gather_rows(hn, src, order=src_order),
                        gather_rows(hn, dst, order=dst_order)], dim=-1)
    he_new = he + _mlp_apply(p["edge_mlp"], msg_in, mlp_layers) * emask
    # node update: h_i' = MLP([h_i, Σ_in m]) + h_i
    agg = segment_sum(he_new * emask, dst, hn.shape[0], order=dst_order)
    hn_new = hn + _mlp_apply(p["node_mlp"], torch.cat([hn, agg], dim=-1), mlp_layers)
    return hn_new, he_new


class MeshGraphNet(Arch):
    def __init__(self, cfg: GNNConfig = GNNConfig(),
                 optimizer: opt_lib.OptimizerConfig | None = None):
        self.cfg = cfg
        self.name = cfg.name
        self.shapes = dict(GNN_SHAPES)
        if optimizer is not None:
            self.optimizer = optimizer
        # models are built per (d_feat, n_out); keep the superset dims
        self.d_feat = max(s.dim("d_feat") for s in self.shapes.values())
        self.n_out = max(s.dim("n_out") for s in self.shapes.values())

    # -- params ---------------------------------------------------------------
    def init_with_axes(self, seed: int = 0, device=None):
        """``node_encoder``, ``edge_encoder``, ``processor`` (the layers'
        ``edge_mlp`` and ``node_mlp`` stacked on a leading layer axis) and
        ``decoder``, drawn in that order from one generator, and their
        axes."""
        cfg = self.cfg
        gen = L.generator(seed, resolve_device(device))
        h, n, dt = cfg.d_hidden, cfg.mlp_layers, cfg.param_dtype
        b = L.Builder(gen, dt)
        b.sub("node_encoder", *_init_mlp_stack(gen, self.d_feat, h, h, n, dt))
        b.sub("edge_encoder", *_init_mlp_stack(gen, cfg.d_edge_feat, h, h, n, dt))

        def one_layer(g):
            bb = L.Builder(g, dt)
            bb.sub("edge_mlp", *_init_mlp_stack(g, 3 * h, h, h, n, dt))
            bb.sub("node_mlp", *_init_mlp_stack(g, 2 * h, h, h, n, dt))
            return bb.build()

        b.sub("processor", *L.stack_layers(gen, cfg.n_layers, one_layer))
        b.sub("decoder", *_init_mlp_stack(gen, h, h, self.n_out, n, dt, norm=False))
        return b.build()

    # -- forward ----------------------------------------------------------------
    def forward(self, params, batch):
        """batch: node_feat [N,F], edge_src/edge_dst [E] int, edge_feat
        [E,Fe], node_mask [N] bool, edge_mask [E] bool -> node outputs
        [N, n_out]."""
        cfg = self.cfg
        nf = batch["node_feat"]
        # pad features to the model's superset width
        if nf.shape[1] < self.d_feat:
            nf = torch.nn.functional.pad(nf, (0, self.d_feat - nf.shape[1]))
        src, dst = batch["edge_src"], batch["edge_dst"]
        emask = batch["edge_mask"].to(nf.dtype)[:, None]

        hn = _mlp_apply(params["node_encoder"], nf, cfg.mlp_layers)
        he = _mlp_apply(params["edge_encoder"], batch["edge_feat"], cfg.mlp_layers)
        remat = cfg.remat and torch.is_grad_enabled()
        # each id set sorted once a batch; the src order serves only the
        # gathers' gradients
        n = hn.shape[0]
        dst_order = segment_order(dst, n)
        src_order = segment_order(src, n) if torch.is_grad_enabled() else None
        stacked = params["processor"]
        for i in range(cfg.n_layers):
            p = L.layer(stacked, i)
            if remat:
                hn, he = checkpoint(_mp_layer, p, hn, he, src, dst, emask, cfg.mlp_layers,
                                    src_order, dst_order, use_reentrant=False)
            else:
                hn, he = _mp_layer(p, hn, he, src, dst, emask, cfg.mlp_layers, src_order,
                                   dst_order)
        return _mlp_apply(params["decoder"], hn, cfg.mlp_layers)

    def loss(self, params, batch):
        out = self.forward(params, batch)
        labels = batch["labels"]
        mask = batch["node_mask"]
        if labels.dtype in (torch.int32, torch.int64):  # node classification
            lbl = torch.where(mask, labels, -1)
            ce = L.cross_entropy(out[None], lbl[None])
            return ce, {"ce": ce}
        # regression (molecule): graph-level target broadcast to nodes
        # ([N, n_out] outputs against [N, 1] labels, as the reference)
        m = mask.to(torch.float32)[:, None]
        mse = torch.sum(((out - labels) ** 2) * m) / torch.clamp(torch.sum(m), min=1.0)
        return mse, {"mse": mse}

    # -- steps ------------------------------------------------------------------
    def padded_sizes(self, shape_name: str) -> tuple[int, int]:
        """(N, E): the step's node and edge buffers, each padded to a
        multiple of 512 (so the node/edge dims shard evenly on any
        production mesh; the masks make the padding free)."""
        d = dict(self.shapes[shape_name].dims)
        if shape_name == "minibatch_lg":
            N, E = d["pad_nodes"], d["pad_edges"]
        elif shape_name == "molecule":
            N, E = d["n_nodes"] * d["batch"], d["n_edges"] * d["batch"]
        else:
            N, E = d["n_nodes"], d["n_edges"]
        return -(-N // PAD_TO) * PAD_TO, -(-E // PAD_TO) * PAD_TO

    def step(self, shape_name: str) -> StepSpec:
        d = dict(self.shapes[shape_name].dims)
        N, E = self.padded_sizes(shape_name)
        F, n_out = d["d_feat"], d["n_out"]
        molecule = shape_name == "molecule"
        specs = {
            "node_feat": spec((N, F)),
            "edge_src": spec((E,), torch.int32),
            "edge_dst": spec((E,), torch.int32),
            "edge_feat": spec((E, self.cfg.d_edge_feat)),
            "node_mask": spec((N,), torch.bool),
            "edge_mask": spec((E,), torch.bool),
            "labels": spec((N, n_out), torch.float32) if molecule else spec((N,), torch.int32),
        }
        axes = {
            "node_feat": ("nodes", None), "edge_src": ("edges",),
            "edge_dst": ("edges",), "edge_feat": ("edges", None),
            "node_mask": ("nodes",), "edge_mask": ("edges",),
            "labels": ("nodes", None) if molecule else ("nodes",),
        }
        return StepSpec(self.make_train_step(), specs, "train", axes)


# -----------------------------------------------------------------------------
# Neighbor sampler (GraphSAGE-style uniform fanout, host numpy)
# -----------------------------------------------------------------------------
class NeighborSampler:
    """Uniform fanout sampler over a CSR adjacency; emits padded subgraphs.

    Used by the minibatch_lg pipeline: roots [B] -> L-hop frontier with
    fanouts, returning a disjoint re-indexed subgraph with fixed buffer
    sizes (pad_nodes/pad_edges) for fixed step shapes. The draws are the
    reference's, call for call, from the same seed.
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 fanouts: tuple[int, ...], seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def sample(self, roots: np.ndarray, pad_nodes: int, pad_edges: int):
        nodes = list(roots)
        node_set = {int(r): i for i, r in enumerate(roots)}
        src_l, dst_l = [], []
        frontier = list(roots)
        for f in self.fanouts:
            nxt = []
            for u in frontier:
                lo, hi = self.indptr[u], self.indptr[u + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = self.rng.integers(lo, hi, size=min(f, 4 * f))
                nbrs = self.indices[take[:f]] if deg > f else \
                    self.indices[lo:hi]
                for v in np.asarray(nbrs):
                    v = int(v)
                    if v not in node_set:
                        node_set[v] = len(nodes)
                        nodes.append(v)
                        nxt.append(v)
                    # message flows neighbor -> u
                    src_l.append(node_set[v])
                    dst_l.append(node_set[u])
            frontier = nxt
        n, e = len(nodes), len(src_l)
        n, e = min(n, pad_nodes), min(e, pad_edges)
        out_nodes = np.zeros(pad_nodes, np.int64)
        out_nodes[:n] = nodes[:n]
        src = np.zeros(pad_edges, np.int32)
        dst = np.zeros(pad_edges, np.int32)
        src[:e] = src_l[:e]
        dst[:e] = dst_l[:e]
        node_mask = np.arange(pad_nodes) < n
        edge_mask = np.arange(pad_edges) < e
        return {
            "orig_nodes": out_nodes, "edge_src": src, "edge_dst": dst,
            "node_mask": node_mask, "edge_mask": edge_mask,
            "n_nodes": n, "n_edges": e,
        }


def random_csr_graph(n_nodes: int, avg_degree: int, seed: int = 0):
    """Synthetic power-law-ish CSR graph for tests/benches."""
    rng = np.random.default_rng(seed)
    deg = np.clip(rng.zipf(1.6, n_nodes), 1, 10 * avg_degree)
    deg = (deg * (avg_degree / max(deg.mean(), 1e-9))).astype(np.int64)
    deg = np.maximum(deg, 1)
    indptr = np.zeros(n_nodes + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n_nodes, size=int(indptr[-1]), dtype=np.int64)
    return indptr, indices
