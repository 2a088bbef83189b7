"""Shared model-building blocks of the recsys archs and the transformer
family: norms, rotary embeddings, GQA attention, the gated MLP, DeepSeek's
mixture of experts and multi-head latent attention, embeddings and the
cross-entropy. The reference's activation constraint ``_constrain`` is a
placement hint to XLA's partitioner with no effect in one process, and has
no counterpart.

Parameters are plain nested dicts of tensors. Every parameter carries a
parallel *logical-axis* annotation tree (same structure, tuples of axis
names) that ``distributed/sharding.py`` maps onto mesh axes; ``Builder``
builds both trees at once. It draws the params from one explicit
``torch.Generator`` with the reference's shapes and stddev rule; the
values differ from the reference's (another generator), so the tests
carry the reference's params across with ``convert``. Without a generator
it builds on ``meta``: the abstract params the specs are computed from.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.kernels.common import stable_topk
from repro_torch.models.flash_attention import flash_attention

Params = dict[str, Any]
Axes = dict[str, Any]


class Builder:
    """Collects (param, logical-axes) pairs drawn from one generator on one
    device. ``gen=None`` builds on ``meta``: shapes, dtypes and axes, with
    nothing allocated and nothing drawn (the reference's ``eval_shape``)."""

    def __init__(self, gen: torch.Generator | None, param_dtype=torch.float32):
        self.gen = gen
        self.device = torch.device("meta") if gen is None else gen.device
        self.dtype = param_dtype
        self.params: Params = {}
        self.axes: Axes = {}

    def _draw(self, shape, std: float) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(tuple(shape), dtype=self.dtype, device=self.device)
        return (torch.randn(tuple(shape), generator=self.gen, device=self.device,
                            dtype=torch.float32) * std).to(self.dtype)

    def normal(self, name: str, shape, axes, stddev: float | None = None,
               by_expert: bool = False):
        """N(0, stddev) (default 1/sqrt(fan-in), fan-in = shape[-2]) drawn in
        fp32, stored in the param dtype. ``by_expert`` draws a leaf with a
        leading experts axis one expert at a time into the stored tensor,
        so the fp32 draw never holds the whole leaf (a deepseek-v3 expert
        leaf is 15 GB in fp32)."""
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = stddev if stddev is not None else 1.0 / math.sqrt(fan_in)
        if by_expert and self.gen is not None:
            out = torch.empty(tuple(shape), dtype=self.dtype, device=self.device)
            for e in range(shape[0]):
                out[e] = self._draw(shape[1:], std)
            self.params[name] = out
        else:
            self.params[name] = self._draw(shape, std)
        self.axes[name] = tuple(axes)
        return self

    def zeros(self, name: str, shape, axes, dtype=None):
        self.params[name] = torch.zeros(tuple(shape), dtype=dtype or self.dtype,
                                        device=self.device)
        self.axes[name] = tuple(axes)
        return self

    def ones(self, name: str, shape, axes):
        self.params[name] = torch.ones(tuple(shape), dtype=self.dtype,
                                       device=self.device)
        self.axes[name] = tuple(axes)
        return self

    def sub(self, name: str, params: Params, axes: Axes):
        self.params[name] = params
        self.axes[name] = axes
        return self

    def build(self) -> tuple[Params, Axes]:
        return self.params, self.axes


def generator(seed: int, device) -> torch.Generator | None:
    """The init generator on ``device`` seeded with ``seed``; None on
    ``meta``, where a ``Builder`` draws nothing."""
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def stack_layers(gen: torch.Generator | None, n_layers: int, make_one):
    """n identical layers' params stacked on a leading layer axis, as the
    reference's scanned blocks, and their axes with ``layers`` prefixed.
    ``make_one(gen) -> (params, axes)``.

    The layers are drawn in order, as a list of them would be, and each is
    copied into a stack allocated after the first, leaf by leaf, so the
    peak is the stack and one layer, not twice the stack."""
    def first_into_stack(tree):
        out = {}
        for k in list(tree):
            leaf = tree.pop(k)      # the drawn layer's leaf is freed once copied
            if isinstance(leaf, dict):
                out[k] = first_into_stack(leaf)
            elif n_layers == 1:
                out[k] = leaf[None]
            else:
                out[k] = leaf.new_empty((n_layers, *leaf.shape))
                out[k][0] = leaf
        return out

    def fill(stacked, tree, i):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                fill(stacked[k], leaf, i)
            else:
                stacked[k][i] = leaf

    first, axes = make_one(gen)
    stacked = first_into_stack(first)
    for i in range(1, n_layers):
        fill(stacked, make_one(gen)[0], i)
    return stacked, prefix_axes(axes, "layers")


def prefix_axes(axes: Axes, name: str) -> Axes:
    """``name`` prepended to every leaf's axes tuple."""
    return {k: prefix_axes(v, name) if isinstance(v, dict) else (name,) + v
            for k, v in axes.items()}


def layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of stacked params."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the reference's custom VJP: math in fp32, cotangents
    emitted in the input dtype (``dx`` in x's, ``dscale`` in scale's)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x32 = x.to(torch.float32)
        r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, r)
        return (x32 * r * scale.to(torch.float32)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, r = ctx.saved_tensors
        x32 = x.to(torch.float32)
        gw = g.to(torch.float32) * scale.to(torch.float32)
        xhat = x32 * r
        dx = r * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
        dscale = torch.sum((g.to(torch.float32) * xhat).reshape(-1, x.shape[-1]), dim=0)
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: math in fp32, output in the input dtype; its gradient is
    the reference's custom VJP (``_RMSNorm``)."""
    return _RMSNorm.apply(x, scale, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm: math in fp32 (float64 input in float64), output in the
    input dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xa = x.to(acc)
    mu = torch.mean(xa, dim=-1, keepdim=True)
    var = torch.mean((xa - mu) ** 2, dim=-1, keepdim=True)
    out = (xa - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(acc) + bias.to(acc)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    """[head_dim / 2] fp32 inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding of x [..., S, H, D] at positions (broadcastable to
    [..., S]): the two halves of the last axis rotate together (not
    interleaved pairs), angles in fp32, output in x's dtype."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                   # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs        # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                          # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_positions: torch.Tensor, k_positions: torch.Tensor,
                  causal: bool = True, window: int | None = None,
                  k_valid: torch.Tensor | None = None,
                  softmax_scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention, exact: q [B, Sq, H, D], k/v [B, Sk, KV, D]
    (query head h = kv * g + i reads KV head kv), optional sliding window
    and cache-slot validity k_valid [B, Sk]; scores in fp32, masked at
    -1e30; output [B, Sq, H, Dv] in q's dtype."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    g = H // KV
    scale = softmax_scale or (1.0 / math.sqrt(D))
    qg = q.reshape(B, Sq, KV, g, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                     k.to(torch.float32)) * scale              # [B, KV, g, Sq, Sk]
    pq = q_positions[:, None, None, :, None]
    pk = k_positions[:, None, None, None, :]
    mask = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    if causal:
        mask &= pk <= pq
    if window is not None:
        mask &= pq - pk < window
    if k_valid is not None:
        mask &= k_valid[:, None, None, None, :]
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def init_embedding(gen: torch.Generator | None, vocab: int, d_model: int, dtype,
                   tied: bool = False) -> tuple[Params, Axes]:
    """``embedding`` [vocab, d_model] with stddev 0.02, and ``unembed``
    [d_model, vocab] where the output projection is not tied to it."""
    b = Builder(gen, dtype)
    b.normal("embedding", (vocab, d_model), ("vocab", "embed"), stddev=0.02)
    if not tied:
        b.normal("unembed", (d_model, vocab), ("embed", "vocab"), stddev=0.02)
    return b.build()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean CE in fp32 (float64 logits in float64); labels < 0 are
    ignored."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    valid = labels >= 0 if mask is None else mask
    safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0] - logz
    n = torch.clamp(torch.sum(valid), min=1)
    return -torch.sum(torch.where(valid, ll, 0.0)) / n


def init_mlp(gen: torch.Generator | None, d_model: int, d_ff: int,
             dtype) -> tuple[Params, Axes]:
    b = Builder(gen, dtype)
    b.normal("w_gate", (d_model, d_ff), ("embed", "mlp"))
    b.normal("w_up", (d_model, d_ff), ("embed", "mlp"))
    b.normal("w_down", (d_ff, d_model), ("mlp", "embed"))
    return b.build()


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SiLU-gated MLP (SwiGLU family)."""
    h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts (shared + fine-grained routed; sort-based dispatch)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts E
    num_shared: int             # shared (always-on) experts
    top_k: int
    d_model: int
    d_ff: int                   # per-expert hidden
    router: str = "softmax_topk"   # "softmax_topk" | "sigmoid_norm" (dsv3)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001
    route_scale: float = 1.0
    # tokens are slotted inside fixed-size groups, as the reference's
    # group-local dispatch (the group count G is the same)
    tokens_per_group: int = 4096


def init_moe(gen: torch.Generator | None, cfg: MoEConfig,
             dtype) -> tuple[Params, Axes]:
    """The router (std 0.02), ``router_bias`` (fp32 zeros whatever the
    param dtype: DeepSeek-V3's aux-loss-free bias), the experts' w_gate /
    w_up [E, d, f] and w_down [E, f, d] (drawn an expert at a time) and,
    with ``num_shared``, one shared MLP of width d_ff * num_shared."""
    b = Builder(gen, dtype)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    b.normal("router", (d, e), ("embed", "experts"), stddev=0.02)
    b.zeros("router_bias", (e,), ("experts",), torch.float32)
    b.normal("w_gate", (e, d, f), ("experts", "embed", "mlp"), by_expert=True)
    b.normal("w_up", (e, d, f), ("experts", "embed", "mlp"), by_expert=True)
    b.normal("w_down", (e, f, d), ("experts", "mlp", "embed"), by_expert=True)
    if cfg.num_shared:
        b.sub("shared", *init_mlp(gen, d, cfg.d_ff * cfg.num_shared, dtype))
    return b.build()


class Routing(NamedTuple):
    """One MoE call's routing and dispatch: gate weights ``gw`` [T, K]
    (fp32) of experts ``ids`` [T, K], router probabilities ``probs`` [T, E]
    (fp32), ``tok_buf`` [G, E, C] (each expert's slots: the token, within
    its group, in each slot; Tg where empty) and ``slot`` [G, Tg, K] (each
    assignment's slot e * C + pos in its group, -1 where it was dropped
    past capacity C)."""

    gw: torch.Tensor
    ids: torch.Tensor
    probs: torch.Tensor
    tok_buf: torch.Tensor
    slot: torch.Tensor

    def dropped(self) -> torch.Tensor:
        """The number of assignments dropped past capacity (0-d, on the
        device: reading it syncs)."""
        return torch.sum(self.slot < 0)


def groups(T: int, cfg: MoEConfig) -> tuple[int, int, int]:
    """(G, Tg, C): the reference's group count (lowered until it divides
    T), tokens per group and per-expert capacity, the same Python
    expressions."""
    E, K = cfg.num_experts, cfg.top_k
    G = max(1, T // max(cfg.tokens_per_group, 1))
    while T % G:
        G -= 1
    Tg = T // G
    return G, Tg, max(8, int(cfg.capacity_factor * Tg * K / E))


def _route(p: Params, x: torch.Tensor, cfg: MoEConfig):
    """Router scores: (gate weights [T, K], expert ids [T, K], probs [T, E]),
    fp32; top-k ties go to the lowest expert id, as ``lax.top_k``."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    if cfg.router == "sigmoid_norm":               # DeepSeek-V3
        scores = torch.sigmoid(logits)
        sel = scores + p["router_bias"][None, :]   # aux-loss-free bias: select
        _, ids = stable_topk(sel, cfg.top_k)
        gw = torch.gather(scores, 1, ids)          # gate with raw scores
        gw = gw / torch.clamp(torch.sum(gw, dim=1, keepdim=True), min=1e-9)
        gw = gw * cfg.route_scale
        probs = scores / torch.clamp(scores.sum(1, keepdim=True), min=1e-9)
    else:                                          # classic softmax top-k
        probs = torch.softmax(logits, dim=1)
        gw, ids = stable_topk(probs, cfg.top_k)
    return gw, ids, probs


def _dispatch_slots(ids: torch.Tensor, E: int, C: int):
    """Slot every group's assignments (ids [G, Tg, K]) into [E, C] buffers,
    the reference's ``_dispatch_group`` for all groups at once: a stable
    sort of the flat assignments t*K + k by expert, so the slots of an
    expert go in flat order and those past C are dropped. Returns
    (tok_buf [G, E, C], slot [G, Tg, K]). Scatters only: no host sync."""
    G, Tg, K = ids.shape
    n = Tg * K
    flat_e = ids.reshape(G, n).long()
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    counts = torch.zeros((G, E), dtype=torch.long, device=ids.device)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 1) - counts
    pos = torch.arange(n, device=ids.device)[None, :] - torch.gather(starts, 1, se)
    keep = pos < C
    sorted_slot = torch.where(keep, se * C + pos, -1)
    # the dropped write one dump column past the buffer, cut off after
    tok_buf = torch.full((G, E * C + 1), Tg, dtype=torch.long, device=ids.device)
    tok_buf.scatter_(1, torch.where(keep, sorted_slot, E * C), order // K)
    slot = torch.empty_like(sorted_slot).scatter_(1, order, sorted_slot)
    return tok_buf[:, :E * C].reshape(G, E, C), slot.reshape(G, Tg, K)


def route(p: Params, x: torch.Tensor, cfg: MoEConfig) -> Routing:
    """``moe_ffn``'s routing and dispatch decisions for tokens x [T, d]."""
    G, Tg, C = groups(x.shape[0], cfg)
    gw, ids, probs = _route(p, x, cfg)
    tok_buf, slot = _dispatch_slots(ids.reshape(G, Tg, cfg.top_k), cfg.num_experts, C)
    return Routing(gw, ids, probs, tok_buf, slot)


def moe_ffn(p: Params, x: torch.Tensor, cfg: MoEConfig):
    """Capacity-bounded top-k MoE with group-local dispatch, the
    reference's algorithm. x: [T, d] (callers flatten batch x seq).
    Returns ([T, d], aux_loss).

    Each expert's GEMMs run over its C slots of every group (empty slots
    hold a zero row), as the reference's ``e``-batched einsums. The
    combine gathers each token's K slots back and sums them over k with
    one fp32 reduction: no scatter and no float atomics, so a call gives
    the same bits every time on the card (the reference's segment sum
    adds the same K terms in expert order; the sums agree to rounding).
    """
    T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    G, Tg, C = groups(T, cfg)
    r = route(p, x, cfg)

    # Switch-style load-balance aux loss (global)
    counts = torch.zeros((E,), dtype=torch.long, device=x.device)
    counts.scatter_add_(0, r.ids.reshape(-1).long(), torch.ones_like(r.ids.reshape(-1).long()))
    load = counts.to(torch.float32) / (T * K)
    aux = cfg.aux_loss_weight * E * torch.sum(load * torch.mean(r.probs, dim=0))

    rows = torch.arange(G, device=x.device)[:, None]
    xpad = torch.cat([x.reshape(G, Tg, d), x.new_zeros((G, 1, d))], dim=1)
    disp = xpad[rows, r.tok_buf.reshape(G, E * C)].reshape(G, E, C, d)
    h = torch.nn.functional.silu(torch.einsum("gecd,edf->gecf", disp, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", disp, p["w_up"])
    out = torch.einsum("gecf,efd->gecd", h, p["w_down"]).reshape(G, E * C, d)

    picked = out[rows[:, :, None], torch.clamp(r.slot, min=0)]     # [G, Tg, K, d]
    gate = torch.where(r.slot >= 0, r.gw.reshape(G, Tg, K), 0.0)
    y = torch.sum(picked.to(torch.float32) * gate[..., None], dim=2)
    y = y.reshape(T, d).to(x.dtype)
    if cfg.num_shared:
        y = y + mlp(p["shared"], x)
    return y, aux


def router_bias_update(p: Params, load: torch.Tensor, lr: float = 0.001) -> Params:
    """DeepSeek-V3 aux-loss-free balancing: nudge under-loaded experts up."""
    target = torch.mean(load)
    return {**p, "router_bias": p["router_bias"] + lr * torch.sign(target - load)}


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2/V3)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10_000.0


def init_mla(gen: torch.Generator | None, cfg: MLAConfig,
             dtype) -> tuple[Params, Axes]:
    b = Builder(gen, dtype)
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    b.normal("wq_a", (d, qr), ("embed", "q_lora"))
    b.ones("q_norm", (qr,), ("q_lora",))
    b.normal("wq_b", (qr, h, qd), ("q_lora", "heads", "head_dim"))
    b.normal("wkv_a", (d, kr + cfg.qk_rope_dim), ("embed", "kv_lora"))
    b.ones("kv_norm", (kr,), ("kv_lora",))
    b.normal("wk_b", (kr, h, cfg.qk_nope_dim), ("kv_lora", "heads", "head_dim"))
    b.normal("wv_b", (kr, h, cfg.v_head_dim), ("kv_lora", "heads", "head_dim"))
    b.normal("wo", (h, cfg.v_head_dim, d), ("heads", "head_dim", "embed"))
    return b.build()


def mla_latents(p: Params, cfg: MLAConfig, x: torch.Tensor, positions: torch.Tensor):
    """What the latent cache holds for x [B, S, d]: the normed compressed
    KV c_kv [B, S, kv_lora_rank] and the roped shared key k_rope [B, S,
    qk_rope_dim], in x's dtype."""
    kv_all = x @ p["wkv_a"]
    c_kv = rms_norm(kv_all[..., :cfg.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(kv_all[..., None, cfg.kv_lora_rank:], positions, cfg.rope_theta)
    return c_kv, k_rope[..., 0, :]


def mla_attention(p: Params, cfg: MLAConfig, x: torch.Tensor, positions: torch.Tensor,
                  causal: bool = True, attn_chunk: int = 512, use_flash: bool = False):
    """Training/prefill form, latents materialized per head. x: [B, S, d].
    q/k are nope + rope wide (192 at deepseek-v3), v ``v_head_dim`` (128).
    With ``use_flash`` (and S > 1) the streaming-softmax path with 512-key
    blocks; else exact attention, q-chunked by the largest divisor of S at
    most ``attn_chunk`` so the [S, S] scores never materialize whole."""
    B, S, _ = x.shape
    h = cfg.n_heads
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)

    q_lat = rms_norm(x @ p["wq_a"], p["q_norm"])                      # [B,S,qr]
    q = torch.einsum("bsr,rhd->bshd", q_lat, p["wq_b"])               # [B,S,H,nope+rope]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    c_kv, k_rope = mla_latents(p, cfg, x, positions)
    k_nope = torch.einsum("bsr,rhd->bshd", c_kv, p["wk_b"])
    v = torch.einsum("bsr,rhd->bshd", c_kv, p["wv_b"])
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, h, cfg.qk_rope_dim)], dim=-1)
    qf = torch.cat([q[..., :cfg.qk_nope_dim], q_rope], dim=-1)

    if use_flash and S > 1:
        out = flash_attention(qf, k, v, positions, positions, causal, None, scale, 512)
        return torch.einsum("bshd,hdo->bso", out, p["wo"])
    cq = min(attn_chunk, S)
    while S % cq:
        cq -= 1
    out = torch.cat([gqa_attention(qf[:, i:i + cq], k, v, q_positions=positions[:, i:i + cq],
                                   k_positions=positions, causal=causal, softmax_scale=scale)
                     for i in range(0, S, cq)], dim=1)
    return torch.einsum("bshd,hdo->bso", out, p["wo"])


def mla_decode(p: Params, cfg: MLAConfig, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_krope: torch.Tensor, position: torch.Tensor, cache_len: torch.Tensor):
    """Absorbed-matrix decode over the compressed latent cache.

    x: [B, 1, d]; cache_ckv: [B, S, kr]; cache_krope: [B, S, rope];
    position [B] (the token's rope position), cache_len [B] (its slot).
    q_nope is absorbed through wk_b (a per-head rank-kr projection), so
    the scores are taken in latent space and the cache stays kr + rope a
    token; scores, softmax and output in fp32. Keys at slots up to
    ``cache_len`` are visible (no position buffer: right until the cache
    wraps, as the reference). Returns (y [B, 1, d] in x's dtype, the
    cache leaves with the token written at its slot)."""
    S = cache_ckv.shape[1]
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    f32 = torch.float32

    q_lat = rms_norm(x @ p["wq_a"], p["q_norm"])
    q = torch.einsum("bsr,rhd->bshd", q_lat, p["wq_b"])[:, 0]         # [B,H,qd]
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = apply_rope(q_rope[:, None], position[:, None], cfg.rope_theta)[:, 0]
    c_new, kr_new = mla_latents(p, cfg, x, position[:, None])          # [B,1,kr], [B,1,rope]

    hot = (torch.arange(S, device=x.device)[None, :] == cache_len[:, None])[..., None]
    cache_ckv = torch.where(hot, c_new, cache_ckv)
    cache_krope = torch.where(hot, kr_new, cache_krope)

    q_abs = torch.einsum("bhd,rhd->bhr", q_nope.to(f32), p["wk_b"].to(f32))   # [B,H,kr]
    s = (torch.einsum("bhr,bsr->bhs", q_abs, cache_ckv.to(f32))
         + torch.einsum("bhd,bsd->bhs", q_rope.to(f32), cache_krope.to(f32))) * scale
    valid = torch.arange(S, device=x.device)[None, :] <= cache_len[:, None]
    pr = torch.softmax(torch.where(valid[:, None, :], s, -1e30), dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", pr, cache_ckv.to(f32))
    out = torch.einsum("bhr,rhd->bhd", o_lat, p["wv_b"].to(f32))
    y = torch.einsum("bhd,hdo->bo", out, p["wo"].to(f32))
    return y[:, None].to(x.dtype), cache_ckv, cache_krope
