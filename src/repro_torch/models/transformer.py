"""Causal-LM architecture family (dense GQA/SWA, DeepSeek MoE, MLA, MTP)
plus the SBERT-style mean-pool encoder the streaming-RAG pipeline embeds with.

One class covers the five LM configs:
  h2o-danube-3-4b / -1.8b : llama+mistral mix — GQA + sliding-window attn
  qwen2-1.5b              : GQA (kv=2) + QKV bias + tied embeddings
  deepseek-moe-16b        : fine-grained MoE (2 shared + 64 routed, top-6)
  deepseek-v3-671b        : MLA + (1 shared + 256 routed, top-8) + MTP

Layers run as a loop over stacked per-layer params (the reference's
``lax.scan``; the first ``first_k_dense`` layers in one stack, the MoE
layers in another), each under ``torch.utils.checkpoint`` when ``remat``
is on and a gradient is being taken (the reference's ``jax.checkpoint``).

Serving: dense/GQA archs use a ring-buffer KV cache sized to the attention
window (SWA ⇒ O(window) memory at 500k context), slot = position %
capacity, empty slots at position -1; MLA uses the compressed latent
cache (c_kv and the roped shared key) with absorbed-matrix decode
(``layers.mla_decode``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.api import Arch, ShapeDef, StepSpec, spec
from repro_torch.models.flash_attention import flash_sdpa
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    tied_embeddings: bool = False
    window: int | None = None          # sliding-window attention
    rope_theta: float = 10_000.0
    # MoE
    moe: L.MoEConfig | None = None
    first_k_dense: int = 0
    dense_ff: int | None = None        # d_ff of the leading dense layers
    # MLA
    mla: L.MLAConfig | None = None
    mtp: bool = False
    mtp_weight: float = 0.3
    # numerics / memory
    param_dtype: torch.dtype = torch.float32
    act_dtype: torch.dtype = torch.float32
    remat: bool = True
    attn_chunk: int = 1024             # q-chunked attention block
    use_flash: bool = False            # streaming-softmax attention
    flash_block_k: int = 512
    train_microbatches: int = 1        # grad-accum splits inside train_step
    # sharding: ``fsdp`` maps the embed axis onto ``data`` in the specs
    # (distributed/sharding.py); ``shard_seq`` is the reference's flag for
    # sequence-sharded attention, which it applies by activation
    # constraints, placement hints with no effect in one process
    fsdp: bool = False
    shard_seq: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# per-layer params
# ---------------------------------------------------------------------------
def _init_attn(gen, cfg: LMConfig):
    b = L.Builder(gen, cfg.param_dtype)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b.normal("wq", (d, h, hd), ("embed", "heads", "head_dim"))
    b.normal("wk", (d, kv, hd), ("embed", "kv_heads", "head_dim"))
    b.normal("wv", (d, kv, hd), ("embed", "kv_heads", "head_dim"))
    b.normal("wo", (h, hd, d), ("heads", "head_dim", "embed"))
    if cfg.qkv_bias:
        b.zeros("bq", (h, hd), ("heads", "head_dim"))
        b.zeros("bk", (kv, hd), ("kv_heads", "head_dim"))
        b.zeros("bv", (kv, hd), ("kv_heads", "head_dim"))
    return b.build()


def _init_block(gen, cfg: LMConfig, kind: str):
    """kind: 'dense' | 'moe'."""
    b = L.Builder(gen, cfg.param_dtype)
    if cfg.mla is not None:
        b.sub("attn", *L.init_mla(gen, cfg.mla, cfg.param_dtype))
    else:
        b.sub("attn", *_init_attn(gen, cfg))
    b.ones("ln1", (cfg.d_model,), ("embed",))
    b.ones("ln2", (cfg.d_model,), ("embed",))
    if kind == "moe":
        b.sub("moe", *L.init_moe(gen, cfg.moe, cfg.param_dtype))
    else:
        b.sub("mlp", *L.init_mlp(gen, cfg.d_model, cfg.dense_ff or cfg.d_ff,
                                 cfg.param_dtype))
    return b.build()


def _n_layers(stacked) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def _embed_tokens(params, cfg: LMConfig, tokens):
    """Embedding rows in act_dtype times sqrt(d_model), the scale cast to
    act_dtype first (in bf16 sqrt(1536) is 39.25)."""
    x = params["embed"]["embedding"].to(cfg.act_dtype)[tokens.long()]
    # a Python float holding the act_dtype value: no host-to-device copy
    return x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(cfg.act_dtype))


# ---------------------------------------------------------------------------
# attention forward (full-head einsum, q-chunked)
# ---------------------------------------------------------------------------
def _qkv(p, cfg: LMConfig, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _sdpa(q, k, v, q_pos, k_pos, cfg: LMConfig, k_valid=None):
    """Exact attention, repeated-KV full-head einsum. q:[B,Sq,H,D] k/v:[B,Sk,KV,D]."""
    g = cfg.n_heads // k.shape[2]
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32), k.to(torch.float32)) * scale
    mask = k_pos[:, None, None, :] <= q_pos[:, None, :, None]
    if cfg.window is not None:
        mask = mask & ((q_pos[:, None, :, None] - k_pos[:, None, None, :]) < cfg.window)
    if k_valid is not None:
        mask = mask & k_valid[:, None, None, :]
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def _chunked_sdpa_wrap(q, k, v, positions, cfg: LMConfig):
    """Causal self-attention of q/k/v over ``positions``: the flash path
    when ``use_flash`` and S > 1, else exact attention q-chunked by the
    largest divisor of S at most ``attn_chunk``."""
    S = q.shape[1]
    if cfg.use_flash and S > 1:
        return flash_sdpa(q, k, v, positions, positions, n_heads=cfg.n_heads,
                          causal=True, window=cfg.window, block_k=cfg.flash_block_k)
    cq = min(cfg.attn_chunk, S)
    while S % cq:
        cq -= 1
    if S <= cq:
        return _sdpa(q, k, v, positions, positions, cfg)
    return torch.cat([_sdpa(q[:, i:i + cq], k, v, positions[:, i:i + cq], positions, cfg)
                      for i in range(0, S, cq)], dim=1)


def _attention(p, cfg: LMConfig, x, positions):
    """Self-attention over x [B,S,d], then the output projection."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = _chunked_sdpa_wrap(q, k, v, positions, cfg)
    return torch.einsum("bshd,hdo->bso", out, p["wo"])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _ffn(p, cfg: LMConfig, h):
    """The block's feed-forward half on h [B, S, d]: (y, aux). A MoE
    layer dispatches the B * S tokens as one flat batch."""
    if "moe" in p:
        B, S, d = h.shape
        y, aux = L.moe_ffn(p["moe"], h.reshape(B * S, d), cfg.moe)
        return y.reshape(B, S, d), aux
    return L.mlp(p["mlp"], h), torch.zeros((), dtype=torch.float32, device=h.device)


def _block(p, cfg: LMConfig, x, positions):
    """One layer, dense or MoE (a MoE layer's params hold ``moe``): (x, aux)."""
    h = L.rms_norm(x, p["ln1"])
    if cfg.mla is not None:
        a = L.mla_attention(p["attn"], cfg.mla, h, positions, attn_chunk=cfg.attn_chunk,
                            use_flash=cfg.use_flash)
    else:
        a = _attention(p["attn"], cfg, h, positions)
    x = x + a
    y, aux = _ffn(p, cfg, L.rms_norm(x, p["ln2"]))
    return x + y, aux


def _scan_blocks(stacked, cfg: LMConfig, x, positions):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(_n_layers(stacked)):
        p = L.layer(stacked, i)
        if remat:
            x, a = checkpoint(_block, p, cfg, x, positions, use_reentrant=False)
        else:
            x, a = _block(p, cfg, x, positions)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# the Arch
# ---------------------------------------------------------------------------
LM_SHAPES = {
    "train_4k": ShapeDef("train_4k", "train", (("seq", 4096), ("batch", 256))),
    "prefill_32k": ShapeDef("prefill_32k", "prefill", (("seq", 32768), ("batch", 32))),
    "decode_32k": ShapeDef("decode_32k", "decode", (("seq", 32768), ("batch", 128))),
    "long_500k": ShapeDef("long_500k", "decode", (("seq", 524288), ("batch", 1))),
}


class TransformerLM(Arch):
    def __init__(self, cfg: LMConfig, optimizer: opt_lib.OptimizerConfig | None = None):
        self.cfg = cfg
        self.name = cfg.name
        self.microbatches = cfg.train_microbatches
        if optimizer is not None:
            self.optimizer = optimizer
        self.shapes = dict(LM_SHAPES)
        if cfg.window is None:
            # pure full attention: long_500k cell is skipped per assignment
            self.shapes["long_500k"] = dataclasses.replace(
                self.shapes["long_500k"],
                skip="pure full attention (no sub-quadratic path); "
                     "noted in DESIGN.md §Arch-applicability")

    # -- init -----------------------------------------------------------------
    def init_with_axes(self, seed: int = 0, device=None):
        """The embeddings, ``dense_layers`` (the first ``first_k_dense``
        layers of a MoE config, every layer of a dense one), ``moe_layers``
        (the rest), ``final_norm`` and, with ``mtp``, ``mtp_block`` and
        ``mtp_proj`` [2d, d]; drawn in that order from one generator, and
        their axes."""
        cfg = self.cfg
        gen = L.generator(seed, resolve_device(device))
        b = L.Builder(gen, cfg.param_dtype)
        b.sub("embed", *L.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.param_dtype,
                                         tied=cfg.tied_embeddings))
        n_moe = cfg.n_layers - cfg.first_k_dense if cfg.moe else 0
        for name, kind, n in (("dense_layers", "dense", cfg.n_layers - n_moe),
                              ("moe_layers", "moe", n_moe)):
            if n:
                b.sub(name, *L.stack_layers(gen, n,
                                            lambda g, k=kind: _init_block(g, cfg, k)))
        b.ones("final_norm", (cfg.d_model,), ("embed",))
        if cfg.mtp:
            b.sub("mtp_block", *_init_block(gen, cfg, "moe" if cfg.moe else "dense"))
            b.normal("mtp_proj", (2 * cfg.d_model, cfg.d_model), ("embed", "embed"))
        return b.build()

    # -- forward --------------------------------------------------------------
    def hidden(self, params, tokens, positions):
        cfg = self.cfg
        x = _embed_tokens(params, cfg, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for stacked in self._stacks(params):
            x, a = _scan_blocks(stacked, cfg, x, positions)
            aux = aux + a
        return L.rms_norm(x, params["final_norm"]), aux

    def logits(self, params, h):
        if self.cfg.tied_embeddings:
            return torch.einsum("bsd,vd->bsv", h, params["embed"]["embedding"].to(h.dtype))
        return h @ params["embed"]["unembed"].to(h.dtype)

    def _ce_chunked(self, params, h, labels, chunk: int = 512):
        """Token-mean CE without materializing [B, S, V] logits: a loop
        over sequence chunks (labels < 0 ignored)."""
        S = h.shape[1]
        cs = min(chunk, S)
        while S % cs:
            cs -= 1
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.int32, device=h.device)
        for i in range(0, S, cs):
            logits = self.logits(params, h[:, i:i + cs]).to(torch.float32)
            li = labels[:, i:i + cs]
            valid = li >= 0
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, torch.clamp(li, min=0).long()[..., None])[..., 0] - logz
            tot = tot - torch.sum(torch.where(valid, ll, 0.0))
            cnt = cnt + torch.sum(valid)
        return tot / torch.clamp(cnt, min=1)

    def loss(self, params, batch):
        """Next-token CE + the MoE aux loss; with ``mtp``, plus
        ``mtp_weight`` x (the depth-1 multi-token prediction's CE + its aux):
        h_t joined with the embedding of token t+1, projected by
        ``mtp_proj`` and run through ``mtp_block``, predicts token t+2."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        h, aux = self.hidden(params, tokens, positions)

        def shifted(by):   # labels: the tokens ``by`` ahead, -1 past the end
            return torch.cat([tokens[:, by:], torch.full((B, by), -1, dtype=tokens.dtype,
                                                         device=tokens.device)], dim=1)

        ce = self._ce_chunked(params, h, shifted(1))
        metrics = {"ce": ce, "aux": aux}
        loss = ce + aux
        if cfg.mtp:
            emb = params["embed"]["embedding"].to(h.dtype)[tokens[:, 1:].long()]
            comb = torch.cat([h[:, :-1], emb], dim=-1) @ params["mtp_proj"]
            h2, aux2 = _block(params["mtp_block"], cfg, comb, positions[:, :-1])
            mtp_ce = self._ce_chunked(params, h2, shifted(2)[:, :-1])
            loss = loss + cfg.mtp_weight * (mtp_ce + aux2)
            metrics["mtp_ce"] = mtp_ce
        return loss, metrics

    # -- serving --------------------------------------------------------------
    def cache_capacity(self, seq_len: int) -> int:
        w = self.cfg.window
        return min(seq_len, w) if w is not None else seq_len

    def cache_specs(self, batch: int, seq_len: int) -> dict:
        """Shapes and dtypes of ``init_cache(batch, seq_len)`` (the
        reference's ``abstract_cache``), allocating nothing: MLA's latent
        cache {ckv, krope, len}, else {k, v, pos, len}."""
        cfg = self.cfg
        Sc = self.cache_capacity(seq_len)
        lens = spec((batch,), torch.int32)
        if cfg.mla is not None:
            lat = (cfg.n_layers, batch, Sc)
            return {"ckv": spec(lat + (cfg.mla.kv_lora_rank,), cfg.act_dtype),
                    "krope": spec(lat + (cfg.mla.qk_rope_dim,), cfg.act_dtype), "len": lens}
        kv = (cfg.n_layers, batch, Sc, cfg.n_kv_heads, cfg.hd)
        return {"k": spec(kv, cfg.act_dtype), "v": spec(kv, cfg.act_dtype),
                "pos": spec((batch, Sc), torch.int32), "len": lens}

    def init_cache(self, batch: int, seq_len: int, device=None):
        """An empty cache on ``device`` (``cuda`` unless given): zeros,
        every slot of a k/v cache at position -1, length 0."""
        dev = resolve_device(device)
        out = {n: torch.zeros(s.shape, dtype=s.dtype, device=dev)
               for n, s in self.cache_specs(batch, seq_len).items()}
        if "pos" in out:
            out["pos"].fill_(-1)
        return out

    def _stacks(self, params):
        """The stacked layers in execution order: the dense stack, then the
        MoE stack."""
        return [params[name] for name in ("dense_layers", "moe_layers") if name in params]

    def _layers(self, params):
        """(cache layer index, layer params) in execution order."""
        layers = [L.layer(stacked, j) for stacked in self._stacks(params)
                  for j in range(_n_layers(stacked))]
        return enumerate(layers)

    def decode_step(self, params, cache, token):
        """One token for every sequence in the batch. token: [B] i32.
        Writes the token at slot ``len % Sc`` of a copy of the cache (the
        reference's one-hot update, by index for k/v; MLA's by
        ``mla_decode``'s own)."""
        cfg = self.cfg
        B = token.shape[0]
        x = _embed_tokens(params, cfg, token)[:, None]
        pos = cache["len"]                                       # [B] current positions
        if cfg.mla is not None:
            slot = pos % cache["ckv"].shape[2]
            ckv_all, kr_all = cache["ckv"].clone(), cache["krope"].clone()
            for i, p_l in self._layers(params):
                a, ckv_all[i], kr_all[i] = L.mla_decode(
                    p_l["attn"], cfg.mla, L.rms_norm(x, p_l["ln1"]), ckv_all[i], kr_all[i],
                    pos, slot)
                x = x + a
                x = x + _ffn(p_l, cfg, L.rms_norm(x, p_l["ln2"]))[0]
            new_cache = {"ckv": ckv_all, "krope": kr_all, "len": cache["len"] + 1}
        else:
            Sc = cache["k"].shape[2]
            rows = torch.arange(B, device=pos.device)
            slot = (pos % Sc).long()
            pos_buf = cache["pos"].clone()
            pos_buf[rows, slot] = pos
            valid = pos_buf >= 0
            k_all, v_all = cache["k"].clone(), cache["v"].clone()
            for i, p_l in self._layers(params):
                h = L.rms_norm(x, p_l["ln1"])
                q, k, v = _qkv(p_l["attn"], cfg, h, pos[:, None])
                k_all[i, rows, slot] = k[:, 0]
                v_all[i, rows, slot] = v[:, 0]
                o = _sdpa(q, k_all[i], v_all[i], pos[:, None], pos_buf, cfg, valid)
                x = x + torch.einsum("bshd,hdo->bso", o, p_l["attn"]["wo"])
                x = x + _ffn(p_l, cfg, L.rms_norm(x, p_l["ln2"]))[0]
            new_cache = {"k": k_all, "v": v_all, "pos": pos_buf, "len": cache["len"] + 1}
        h = L.rms_norm(x, params["final_norm"])
        return self.logits(params, h)[:, 0], new_cache

    def prefill(self, params, tokens, budget: int | None = None):
        """Prefill: returns (last-position logits, populated cache).

        The cache is laid out ring-buffer style (slot = position % capacity)
        so decode_step can continue writing where prefill left off — for SWA
        archs the last `window` positions land at their ring slots via roll.
        For full-attention archs pass ``budget`` >= S + expected decode steps
        so new tokens extend the cache instead of wrapping.
        """
        cfg = self.cfg
        B, S = tokens.shape
        dev = tokens.device
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        x = _embed_tokens(params, cfg, tokens)
        Sc = self.cache_capacity(budget if budget is not None else S)
        pad = max(0, Sc - S)
        Sc = min(Sc, S) if pad == 0 else Sc
        shift = ((S - Sc) % Sc) if Sc <= S else 0

        def fit(buf):   # [B, S, ...] -> [B, Sc, ...] (tail-slice or zero-pad)
            if pad:
                return torch.cat([buf, buf.new_zeros((B, pad) + buf.shape[2:])], dim=1)
            return buf[:, S - Sc:]

        def ring(buf):  # [B, Sc, ...]: place position p at slot p % Sc
            return torch.roll(buf, shift, dims=1) if shift else buf

        # per layer, the two cached leaves: MLA's normed c_kv and roped
        # shared key, else k and v
        cached = ([], [])
        for _, p_l in self._layers(params):
            h = L.rms_norm(x, p_l["ln1"])
            if cfg.mla is not None:
                pair = L.mla_latents(p_l["attn"], cfg.mla, h, positions)
                x = x + L.mla_attention(p_l["attn"], cfg.mla, h, positions,
                                        attn_chunk=cfg.attn_chunk, use_flash=cfg.use_flash)
            else:
                q, *pair = _qkv(p_l["attn"], cfg, h, positions)
                o = _chunked_sdpa_wrap(q, *pair, positions, cfg)
                x = x + torch.einsum("bshd,hdo->bso", o, p_l["attn"]["wo"])
            x = x + _ffn(p_l, cfg, L.rms_norm(x, p_l["ln2"]))[0]
            for into, buf in zip(cached, pair):
                into.append(ring(fit(buf)))
        first, second = (torch.stack(c) for c in cached)
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        if cfg.mla is not None:
            cache = {"ckv": first, "krope": second, "len": lens}
        else:
            if pad:
                pos_slice = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                                       torch.full((pad,), -1, dtype=torch.int32, device=dev)])
            else:
                pos_slice = torch.arange(S - Sc, S, dtype=torch.int32, device=dev)
            cache = {"k": first, "v": second,
                     "pos": ring(pos_slice.expand(B, Sc)).contiguous(), "len": lens}
        h = L.rms_norm(x, params["final_norm"])
        return self.logits(params, h[:, -1:])[:, 0], cache

    # -- steps -----------------------------------------------------------------
    def step(self, shape_name: str) -> StepSpec:
        sh = self.shapes[shape_name]
        B, S = sh.dim("batch"), sh.dim("seq")
        if sh.kind == "train":
            M = max(1, self.cfg.train_microbatches)
            if M > 1:
                # the microbatch axis is pre-split in the input spec, as the
                # reference's: make_train_step splits entries whose leading dim is M
                assert B % M == 0, (B, M)
                return StepSpec(self.make_train_step(),
                                {"tokens": spec((M, B // M, S), torch.int32)}, "train",
                                {"tokens": (None, "batch", "seq")})
            return StepSpec(self.make_train_step(), {"tokens": spec((B, S), torch.int32)},
                            "train", {"tokens": ("batch", "seq")})
        if sh.kind == "prefill":
            return StepSpec(lambda params, batch: self.prefill(params, batch["tokens"]),
                            {"tokens": spec((B, S), torch.int32)}, "serve",
                            {"tokens": ("batch", "seq")})
        # decode: one new token against a seq_len-deep cache
        return StepSpec(
            lambda params, batch: self.decode_step(params, batch["cache"], batch["token"]),
            {"token": spec((B,), torch.int32), "cache": self.cache_specs(B, S)}, "serve",
            {"token": ("batch",), "cache": None})


# ---------------------------------------------------------------------------
# SBERT-style encoder (the paper's embedding model, trained in-repo)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    name: str = "sbert_encoder"
    n_layers: int = 6
    d_model: int = 384
    n_heads: int = 6
    d_ff: int = 1536
    vocab: int = 30522
    max_len: int = 128
    param_dtype: torch.dtype = torch.float32


class EncoderEmbedder(Arch):
    """Bidirectional encoder + mean pooling; InfoNCE contrastive loss."""

    def __init__(self, cfg: EncoderConfig = EncoderConfig()):
        self.cfg = cfg
        self.name = cfg.name
        self.shapes = {
            "train_pairs": ShapeDef("train_pairs", "train", (("batch", 256), ("seq", 128))),
            "embed": ShapeDef("embed", "serve", (("batch", 512), ("seq", 128))),
        }

    def _lm(self) -> LMConfig:
        c = self.cfg
        return LMConfig(name=c.name, n_layers=c.n_layers, d_model=c.d_model,
                        n_heads=c.n_heads, n_kv_heads=c.n_heads, d_ff=c.d_ff,
                        vocab=c.vocab, tied_embeddings=True, remat=False,
                        param_dtype=c.param_dtype)

    def init_with_axes(self, seed: int = 0, device=None):
        cfg = self._lm()
        gen = L.generator(seed, resolve_device(device))
        b = L.Builder(gen, cfg.param_dtype)
        b.sub("embed", *L.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.param_dtype,
                                         tied=True))
        b.sub("layers", *L.stack_layers(gen, cfg.n_layers,
                                        lambda g: _init_block(g, cfg, "dense")))
        b.ones("final_norm", (cfg.d_model,), ("embed",))
        return b.build()

    def embed(self, params, tokens, mask):
        """Unit-norm [B, d] embeddings of token rows [B, S] under their
        padding mask [B, S]: bidirectional attention with padding keys at
        -1e30, no sqrt(d) scaling of the embeddings, masked-mean pooling
        (an all-padding row pools to the zero vector)."""
        cfg = self._lm()
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        x = params["embed"]["embedding"][tokens.long()]
        for i in range(_n_layers(params["layers"])):
            p_l = L.layer(params["layers"], i)
            h = L.rms_norm(x, p_l["ln1"])
            q, k, v = _qkv(p_l["attn"], cfg, h, positions)
            s = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32),
                             k.to(torch.float32)) / math.sqrt(cfg.hd)
            pr = torch.softmax(torch.where(mask[:, None, None, :], s, -1e30), dim=-1)
            o = torch.einsum("bhqs,bshd->bqhd", pr, v.to(torch.float32))
            x = x + torch.einsum("bshd,hdo->bso", o.to(x.dtype), p_l["attn"]["wo"])
            x = x + L.mlp(p_l["mlp"], L.rms_norm(x, p_l["ln2"]))
        x = L.rms_norm(x, params["final_norm"])
        m = mask.to(torch.float32)[..., None]
        pooled = torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
        return pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True),
                                    min=1e-6)

    def loss(self, params, batch):
        """InfoNCE over (anchor, positive) token batches, temperature 0.05,
        symmetric; ``alignment`` is the mean anchor·positive cosine."""
        za = self.embed(params, batch["anchor"], batch["anchor_mask"])
        zp = self.embed(params, batch["positive"], batch["positive_mask"])
        logits = (za @ zp.T) / 0.05
        labels = torch.arange(za.shape[0], device=za.device)
        loss = 0.5 * (L.cross_entropy(logits, labels) + L.cross_entropy(logits.T, labels))
        return loss, {"alignment": torch.mean(torch.sum(za * zp, dim=-1))}

    def step(self, shape_name: str) -> StepSpec:
        sh = self.shapes[shape_name]
        B, S = sh.dim("batch"), sh.dim("seq")
        if sh.kind == "train":
            names = ("anchor", "anchor_mask", "positive", "positive_mask")
            return StepSpec(self.make_train_step(), {
                "anchor": spec((B, S), torch.int32),
                "anchor_mask": spec((B, S), torch.bool),
                "positive": spec((B, S), torch.int32),
                "positive_mask": spec((B, S), torch.bool)}, "train",
                {k: ("batch", "seq") for k in names})
        return StepSpec(lambda params, batch: self.embed(params, batch["tokens"], batch["mask"]),
                        {"tokens": spec((B, S), torch.int32), "mask": spec((B, S), torch.bool)},
                        "serve", {"tokens": ("batch", "seq"), "mask": ("batch", "seq")})
