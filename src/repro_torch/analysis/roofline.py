"""Three-term roofline of one step, from the port's op counter.

    compute term    = sum over dtypes t of flops_by_dtype[t] / peak[t]
    memory term     = bytes / HBM_BW
    collective term = collective_bytes / LINK_BW

Sources: ``analysis.hlo_cost`` (flops by dtype, bytes, collective bytes,
counted op by op on PyTorch's dispatch) and, for a step on a mesh,
``launch.dryrun``'s collective model of the ``Trainer``'s gather and
split.

Hardware constants: one NVIDIA H100 SXM, NVIDIA's published dense peaks
at its full 700 W power limit: 989 TFLOP/s in bf16 and fp16 on the tensor
cores, 1,979 in fp8 and int8, 67 TFLOP/s in fp32 outside them (the port
turns TF32 off: ``kernels/common.require_full_fp32``), HBM3 at 3.35 TB/s,
NVLink 450 GB/s each way. A term is a model against those peaks, not a
measurement, and a card set below 700 W runs below them.
"""
from __future__ import annotations

import dataclasses
import json

# FLOP/s by the dtype of an op's operands (``str(dtype)`` without
# ``torch.``); any other dtype is counted at the fp32 rate
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float8_e4m3fn": 1979e12, "float8_e5m2": 1979e12, "int8": 1979e12}
HBM_BW = 3.35e12           # bytes/s of one card's HBM3
LINK_BW = 450e9            # bytes/s of NVLink, each way


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int                     # cards the step runs on (the port: 1)
    flops_per_chip: float          # counted flops of the whole step
    bytes_per_chip: float          # counted bytes, op by op, unfused
    collective_bytes_per_chip: float
    collectives: dict
    model_flops: float             # 6·N_active·D (global, analytic)
    memory_per_chip: float | None  # live tensor bytes at their peak
    compile_seconds: float         # seconds of the counted run
    flops_by_dtype: dict           # flops_per_chip split by operand dtype

    @property
    def compute_term(self) -> float:
        return sum(f / peak_flops(t) for t, f in self.flops_by_dtype.items())

    @property
    def memory_term(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def collective_term(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_term, "memory": self.memory_term,
                 "collective": self.collective_term}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted flops on every chip): remat and
        redundancy waste."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def step_time_bound(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_term, self.memory_term, self.collective_term)

    @property
    def roofline_fraction(self) -> float:
        """Compute term / max term: 1.0 is compute-bound at peak; lower
        means memory or collectives dominate."""
        t = self.step_time_bound
        return (self.compute_term / t) if t > 0 else 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("compute_term", "memory_term", "collective_term",
                  "dominant", "useful_flops_fraction", "step_time_bound",
                  "roofline_fraction"):
            d[k] = getattr(self, k)
        return d


def lm_active_params(cfg) -> float:
    """Active (per-token) parameter count of an LMConfig, embeddings excluded."""
    d, hd = cfg.d_model, cfg.hd
    if cfg.mla is not None:
        m = cfg.mla
        attn = (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads *
                (m.qk_nope_dim + m.qk_rope_dim)
                + d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
                + cfg.n_heads * m.v_head_dim * d)
    else:
        attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
            + cfg.n_heads * hd * d
    n_moe = (cfg.n_layers - cfg.first_k_dense) if cfg.moe else 0
    n_dense = cfg.n_layers - n_moe
    dense_ff = cfg.dense_ff or cfg.d_ff
    dense_mlp = 3 * d * dense_ff
    total = n_dense * (attn + dense_mlp)
    if cfg.moe:
        mc = cfg.moe
        active = (mc.top_k + mc.num_shared) * 3 * d * mc.d_ff
        total += n_moe * (attn + active)
    return float(total)


def model_flops_for(arch, shape_name: str) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D for LM training; 2·N·D serving;
    message-passing/embedding analogues for GNN/recsys."""
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.models.transformer import LMConfig

    sh = arch.shapes[shape_name]
    dims = dict(sh.dims)
    cfg = getattr(arch, "cfg", None)

    if isinstance(cfg, LMConfig):
        n_active = lm_active_params(cfg)
        if sh.kind == "train":
            tokens = dims["seq"] * dims["batch"]
            f = 6.0 * n_active * tokens
            if cfg.mtp:
                f *= 1.0 + 1.0 / max(cfg.n_layers, 1)
            return f
        if sh.kind == "prefill":
            return 2.0 * n_active * dims["seq"] * dims["batch"]
        # decode: one token per sequence + attention over the cache
        f = 2.0 * n_active * dims["batch"]
        if cfg.mla is not None:
            per_tok = cfg.n_layers * cfg.n_heads * (
                cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * 2
            f += 2.0 * per_tok * dims["seq"] * dims["batch"]
        else:
            win = cfg.window or dims["seq"]
            kv = min(dims["seq"], win)
            f += (2.0 * cfg.n_layers * cfg.n_heads * cfg.hd * 2
                  * kv * dims["batch"])
        return f

    if isinstance(cfg, GNNConfig):
        h = cfg.d_hidden
        if shape_name == "minibatch_lg":
            n, e = dims["pad_nodes"], dims["pad_edges"]
        elif shape_name == "molecule":
            n = dims["n_nodes"] * dims["batch"]
            e = dims["n_edges"] * dims["batch"]
        else:
            n, e = dims["n_nodes"], dims["n_edges"]
        per_layer = e * (3 * h) * h * 2 * (cfg.mlp_layers + 1) \
            + n * (2 * h) * h * 2 * (cfg.mlp_layers + 1)
        fwd = cfg.n_layers * per_layer + (n * dims["d_feat"] * h
                                          + e * cfg.d_edge_feat * h) * 2
        return 3.0 * fwd  # fwd+bwd

    # recsys: embedding gathers + interaction + MLP, per example
    B = dims["batch"]
    d = getattr(arch, "embed_dim", 64)
    hist = getattr(arch, "hist_len", 0)
    per_ex = 2.0 * hist * d * d if hist else 2.0 * 39 * d
    if sh.kind == "train":
        per_ex *= 3.0
    if sh.kind == "retrieval":
        per_ex += 2.0 * dims.get("n_candidates", 0) * d
    return per_ex * B


def render_markdown_table(reports: list[RooflineReport]) -> str:
    head = ("| arch | shape | mesh | compute s | memory s | collective s | "
            "dominant | model/counted flops | roofline frac |\n"
            "|---|---|---|---|---|---|---|---|---|")
    rows = [head]
    for r in reports:
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_term:.2e} "
            f"| {r.memory_term:.2e} | {r.collective_term:.2e} | {r.dominant} "
            f"| {r.useful_flops_fraction:.3f} | {r.roofline_fraction:.3f} |")
    return "\n".join(rows)


def load_reports(paths) -> list[RooflineReport]:
    out = []
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        d = {k: v for k, v in d.items() if k in
             {f.name for f in dataclasses.fields(RooflineReport)}}
        out.append(RooflineReport(**d))
    return out
