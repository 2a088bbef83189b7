"""RecSys architecture family: MIND, BERT4Rec, DIEN, FM.

The hot path is the huge sparse embedding table (10^6–10^7 rows): lookups
are gathers and EmbeddingBag (``kernels/bag``, differentiable: its
backward is a kernel too); ``retrieval_cand`` (1 query x 1,000,000
candidates) is exact MIPS over the full item table (``kernels/mips``), the
same retrieval op as the streaming-RAG index.

Training losses: CTR BCE (FM, DIEN) and sampled softmax (BERT4Rec, MIND)
with N_NEG shared negatives. Every function mirrors the reference's
``models/recsys.py`` op for op, its quirks included.

Random draws are explicit: a train batch may carry its sampled negatives
(``negatives``, [N_NEG] item ids) and, for BERT4Rec, its mask uniforms
(``mask_u``, [B, S] in [0, 1)); what it does not carry is drawn from a
``torch.Generator`` on the batch's device seeded from ``batch["rng"]``.
The numbers differ from ``jax.random``'s for the same key, so the tests
hand both packages the reference's own draws.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.bag.ops import embedding_bag_sorted, gather_rows
from repro_torch.kernels.common import resolve_device, stable_topk
from repro_torch.kernels.mips.ops import mips_topk
from repro_torch.models import layers as L
from repro_torch.models.api import Arch, ShapeDef, StepSpec, spec
from repro_torch.train.optimizer import OptimizerConfig

RECSYS_SHAPES = {
    "train_batch": ShapeDef("train_batch", "train", (("batch", 65536),)),
    "serve_p99": ShapeDef("serve_p99", "serve", (("batch", 512),)),
    "serve_bulk": ShapeDef("serve_bulk", "serve", (("batch", 262144),)),
    "retrieval_cand": ShapeDef("retrieval_cand", "retrieval",
                               (("batch", 1), ("n_candidates", 1_000_000))),
}

N_ITEMS = 1_000_000          # item vocabulary (huge-embedding regime)
N_NEG = 512                  # sampled-softmax negatives


def _mlp_tower(gen, dims, dtype, prefix="mlp"):
    b = L.Builder(gen, dtype)
    for i in range(len(dims) - 1):
        b.normal(f"{prefix}_w{i}", (dims[i], dims[i + 1]), ("rs_in", "rs_out"))
        b.zeros(f"{prefix}_b{i}", (dims[i + 1],), ("rs_out",))
    return b.build()


def _mlp_run(p, x, n, prefix="mlp", final_act=False):
    for i in range(n):
        x = x @ p[f"{prefix}_w{i}"] + p[f"{prefix}_b{i}"]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (the reference's ``jnp.take``); its gradient, where
    the table requires one, is the ``gather_backward`` kernel on the card."""
    return gather_rows(table, ids)


def _generator(batch, device) -> torch.Generator:
    """A generator on ``device`` seeded from the batch's two uint32 key
    words."""
    hi, lo = (int(x) for x in batch["rng"].tolist())
    gen = torch.Generator(device=device)
    gen.manual_seed((hi << 32) | lo)
    return gen


def _sampled_softmax(user_vec, target, item_table, negs):
    """Shared-negative sampled softmax: own positive + N shared negatives
    (``negs``: [N] row ids of ``item_table``)."""
    pos = torch.sum(user_vec * _rows(item_table, target), dim=-1, keepdim=True)
    neg = user_vec @ _rows(item_table, negs).T         # [B, N]
    logits = torch.cat([pos, neg], dim=1)               # [B, 1+N]
    labels = torch.zeros((logits.shape[0],), dtype=torch.int32, device=logits.device)
    return L.cross_entropy(logits[None], labels[None])


def _bce(logits, y):
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


class RecSysArch(Arch):
    """Shared scaffolding: shapes, step plumbing, retrieval MIPS."""

    hist_len: int = 50
    embed_dim: int = 64

    def __init__(self, optimizer: OptimizerConfig | None = None):
        self.shapes = dict(RECSYS_SHAPES)
        if optimizer is not None:
            self.optimizer = optimizer

    def init_with_axes(self, seed: int = 0, device=None):
        return self._init(L.generator(seed, resolve_device(device)))

    # subclasses implement: _init(gen) -> (params, axes), user_vectors(params, batch) -> [B, I, d],
    # score(params, batch) -> [B] logits, loss(params, batch)
    def user_vectors(self, params, batch):
        raise NotImplementedError

    def retrieve(self, params, batch, k: int = 100):
        """1 query vs the full item table: exact MIPS + top-k. The top k of
        the flat I*k interest winners may hold an item twice (it won for
        two interests); like the reference, nothing deduplicates."""
        u = self.user_vectors(params, batch)          # [B, I, d]
        table = params["item_emb"]
        valid = torch.ones((table.shape[0],), dtype=torch.bool, device=table.device)
        B, I, d = u.shape
        scores, ids = mips_topk(u.reshape(B * I, d).contiguous(), table, valid, k)
        # multi-interest: max-combine per query
        flat = scores.reshape(B, I * k)
        top, pos = stable_topk(flat, k)
        return top, torch.gather(ids.reshape(B, I * k), 1, pos)

    def _hist_specs(self, B):
        return {
            "hist": spec((B, self.hist_len), torch.int32),
            "hist_mask": spec((B, self.hist_len), torch.bool),
            "target": spec((B,), torch.int32),
            "labels": spec((B,), torch.float32),
            "rng": spec((2,), torch.uint32),
        }

    _HIST_AXES = {
        "hist": ("batch", None), "hist_mask": ("batch", None),
        "target": ("batch",), "labels": ("batch",), "rng": (None,),
    }

    def step(self, shape_name: str) -> StepSpec:
        sh = self.shapes[shape_name]
        B = sh.dim("batch")
        if sh.kind == "train":
            return StepSpec(self.make_train_step(), self._hist_specs(B), "train",
                            dict(self._HIST_AXES))
        if sh.kind == "retrieval":
            def fn(params, batch):
                return self.retrieve(params, batch)
            specs = self._hist_specs(B)
            specs.pop("labels")
            axes = {k: v for k, v in self._HIST_AXES.items() if k != "labels"}
            return StepSpec(fn, specs, "serve", axes)

        def fn(params, batch):
            return self.score(params, batch)
        return StepSpec(fn, self._hist_specs(B), "serve", dict(self._HIST_AXES))


# -----------------------------------------------------------------------------
# MIND — multi-interest capsule routing (Li et al., arXiv:1904.08030)
# -----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    n_items: int = N_ITEMS
    param_dtype: torch.dtype = torch.float32


class MIND(RecSysArch):
    def __init__(self, cfg: MINDConfig = MINDConfig(), **kw):
        self.cfg = cfg
        self.name = cfg.name
        self.hist_len = cfg.hist_len
        self.embed_dim = cfg.embed_dim
        super().__init__(**kw)

    def _init(self, gen):
        cfg = self.cfg
        b = L.Builder(gen, cfg.param_dtype)
        d = cfg.embed_dim
        b.normal("item_emb", (cfg.n_items, d), ("item_vocab", "rs_feat"),
                 stddev=0.02)
        b.normal("bilinear", (d, d), ("rs_in", "rs_out"))  # B2I capsule map
        # label-aware attention pow + profile projection (bag feature)
        b.normal("profile_proj", (d, d), ("rs_in", "rs_out"))
        return b.build()

    def _interests(self, params, hist_emb, mask):
        """Dynamic routing B2I: hist_emb [B,S,d] -> interests [B,I,d]. The
        routing logits start from the mean over all S positions, masked
        ones included, and scale by 1 + i/I per capsule (the reference's
        deterministic init)."""
        cfg = self.cfg
        B, S, d = hist_emb.shape
        ncap = cfg.n_interests
        beh = hist_emb @ params["bilinear"]                 # [B,S,d]
        logits = torch.einsum("bsd,bd->bs", beh, torch.mean(beh, 1))[..., None]
        logits = logits.expand(B, S, ncap) * (
            1.0 + torch.arange(ncap, dtype=torch.float32, device=beh.device) / ncap)
        m = mask.to(torch.float32)[..., None]
        caps = None
        for _ in range(cfg.capsule_iters):
            w = torch.softmax(logits, dim=-1) * m           # [B,S,I]
            caps = torch.einsum("bsi,bsd->bid", w, beh)     # [B,I,d]
            # squash, with the reference's sqrt(n2 + 1e-9)
            n2 = torch.sum(caps * caps, -1, keepdim=True)
            caps = caps * (n2 / (1 + n2)) / torch.sqrt(n2 + 1e-9)
            logits = logits + torch.einsum("bsd,bid->bsi", beh, caps)
        return caps

    def user_vectors(self, params, batch):
        hist, mask = batch["hist"], batch["hist_mask"]
        hist_emb = _rows(params["item_emb"], hist)
        caps = self._interests(params, hist_emb, mask)
        # ragged profile feature via EmbeddingBag: every one of the B*S
        # entries goes in (masked ones at row 0 with weight 0), so the mean
        # divides by S, not by the number of valid entries; the segment ids
        # are non-decreasing by construction, so the bag needs no sort
        B, S = hist.shape
        seg = torch.arange(B, dtype=torch.int32, device=hist.device)[:, None] \
            .expand(B, S).contiguous().view(-1)
        idx = torch.where(mask, hist, 0).reshape(-1)
        w = mask.to(torch.float32).reshape(-1)
        prof = embedding_bag_sorted(params["item_emb"], idx, seg, B, w, "mean")
        prof = (prof @ params["profile_proj"])[:, None]     # [B,1,d]
        return caps + 0.1 * prof                            # broadcast add

    def score(self, params, batch):
        u = self.user_vectors(params, batch)                # [B,I,d]
        t = _rows(params["item_emb"], batch["target"])      # [B,d]
        return torch.max(torch.einsum("bid,bd->bi", u, t), dim=1).values

    def loss(self, params, batch):
        u = self.user_vectors(params, batch)                # [B,I,d]
        t = _rows(params["item_emb"], batch["target"])
        # label-aware attention (pow 2) combines interests per target
        att = torch.softmax(torch.einsum("bid,bd->bi", u, t) * 2.0, dim=1)
        uv = torch.einsum("bi,bid->bd", att, u)
        negs = batch.get("negatives")
        if negs is None:
            negs = torch.randint(0, params["item_emb"].shape[0], (N_NEG,),
                                 generator=_generator(batch, u.device), device=u.device)
        ce = _sampled_softmax(uv, batch["target"], params["item_emb"], negs)
        return ce, {"ce": ce}


# -----------------------------------------------------------------------------
# BERT4Rec — bidirectional seq model (Sun et al., arXiv:1904.06690)
# -----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BERT4RecConfig:
    name: str = "bert4rec"
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    n_items: int = N_ITEMS
    mask_frac: float = 0.15
    param_dtype: torch.dtype = torch.float32


class BERT4Rec(RecSysArch):
    def __init__(self, cfg: BERT4RecConfig = BERT4RecConfig(), **kw):
        self.cfg = cfg
        self.name = cfg.name
        self.hist_len = cfg.seq_len
        self.embed_dim = cfg.embed_dim
        super().__init__(**kw)

    def _init(self, gen):
        cfg = self.cfg
        d = cfg.embed_dim
        b = L.Builder(gen, cfg.param_dtype)
        b.normal("item_emb", (cfg.n_items + 1, d), ("item_vocab", "rs_feat"),
                 stddev=0.02)  # +1 = [MASK]
        b.normal("pos_emb", (cfg.seq_len, d), (None, "rs_feat"), stddev=0.02)

        def blk(g):
            bb = L.Builder(g, cfg.param_dtype)
            hd = d // cfg.n_heads
            bb.normal("wq", (d, cfg.n_heads, hd), ("embed", "heads", "head_dim"))
            bb.normal("wk", (d, cfg.n_heads, hd), ("embed", "heads", "head_dim"))
            bb.normal("wv", (d, cfg.n_heads, hd), ("embed", "heads", "head_dim"))
            bb.normal("wo", (cfg.n_heads, hd, d), ("heads", "head_dim", "embed"))
            bb.sub("mlp", *L.init_mlp(g, d, 4 * d, cfg.param_dtype))
            bb.ones("ln1", (d,), ("embed",))
            bb.ones("ln2", (d,), ("embed",))
            return bb.build()

        b.sub("blocks", *L.stack_layers(gen, cfg.n_blocks, blk))
        b.ones("final_norm", (d,), ("embed",))
        return b.build()

    def encode(self, params, hist, mask):
        x = _rows(params["item_emb"], hist) + params["pos_emb"][None]
        blocks = params["blocks"]
        for i in range(blocks["ln1"].shape[0]):
            p_l = L.layer(blocks, i)
            h = L.rms_norm(x, p_l["ln1"])
            q = torch.einsum("bsd,dhk->bshk", h, p_l["wq"])
            k = torch.einsum("bsd,dhk->bshk", h, p_l["wk"])
            v = torch.einsum("bsd,dhk->bshk", h, p_l["wv"])
            s = torch.einsum("bqhd,bshd->bhqs", q, k) / math.sqrt(q.shape[-1])
            s = torch.where(mask[:, None, None, :], s, -1e30)
            o = torch.einsum("bhqs,bshd->bqhd", torch.softmax(s, -1), v)
            xc = x + torch.einsum("bqhd,hdo->bqo", o, p_l["wo"])
            h2 = L.rms_norm(xc, p_l["ln2"])
            x = xc + L.mlp(p_l["mlp"], h2)
        return L.rms_norm(x, params["final_norm"])

    def user_vectors(self, params, batch):
        h = self.encode(params, batch["hist"], batch["hist_mask"])
        return h[:, -1:, :]  # last position = next-item query vector

    def score(self, params, batch):
        u = self.user_vectors(params, batch)[:, 0]
        return torch.sum(u * _rows(params["item_emb"], batch["target"]), dim=-1)

    def loss(self, params, batch):
        """Cloze objective: mask random positions, predict them (sampled)."""
        cfg = self.cfg
        hist, hmask = batch["hist"], batch["hist_mask"]
        B, S = hist.shape
        mask_u, negs = batch.get("mask_u"), batch.get("negatives")
        if mask_u is None or negs is None:
            gen = _generator(batch, hist.device)
            if mask_u is None:
                mask_u = torch.rand((B, S), generator=gen, device=hist.device)
            if negs is None:
                negs = torch.randint(0, cfg.n_items, (N_NEG,), generator=gen,
                                     device=hist.device)
        mask_pos = (mask_u < cfg.mask_frac) & hmask
        masked = torch.where(mask_pos, cfg.n_items, hist)    # [MASK] id
        h = self.encode(params, masked, hmask)
        # gather one masked position per row (first masked, else position 0)
        idx = torch.argmax(mask_pos.to(torch.int8), dim=1)
        rows = torch.arange(B, device=hist.device)
        uv = h[rows, idx]
        tgt = hist[rows, idx]
        ce = _sampled_softmax(uv, tgt, params["item_emb"][: cfg.n_items], negs)
        return ce, {"ce": ce}


# -----------------------------------------------------------------------------
# DIEN — interest evolution w/ AUGRU (Zhou et al., arXiv:1809.03672)
# -----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: tuple[int, ...] = (200, 80)
    n_items: int = N_ITEMS
    param_dtype: torch.dtype = torch.float32


def _init_gru(gen, d_in, d_h, dtype, prefix):
    b = L.Builder(gen, dtype)
    b.normal(f"{prefix}_wx", (d_in, 3 * d_h), ("rs_in", "rs_out"))
    b.normal(f"{prefix}_wh", (d_h, 3 * d_h), ("rs_in", "rs_out"))
    b.zeros(f"{prefix}_b", (3 * d_h,), ("rs_out",))
    return b.build()


def _gru_cell(p, prefix, x, h):
    g = h.shape[-1]
    gx = x @ p[f"{prefix}_wx"] + p[f"{prefix}_b"]
    gh = h @ p[f"{prefix}_wh"]
    z = torch.sigmoid(gx[..., :g] + gh[..., :g])
    r = torch.sigmoid(gx[..., g:2 * g] + gh[..., g:2 * g])
    n = torch.tanh(gx[..., 2 * g:] + r * gh[..., 2 * g:])
    return (1 - z) * n + z * h


class DIEN(RecSysArch):
    def __init__(self, cfg: DIENConfig = DIENConfig(), **kw):
        self.cfg = cfg
        self.name = cfg.name
        self.hist_len = cfg.seq_len
        self.embed_dim = cfg.embed_dim
        super().__init__(**kw)

    def _init(self, gen):
        cfg = self.cfg
        b = L.Builder(gen, cfg.param_dtype)
        d, g = cfg.embed_dim, cfg.gru_dim
        b.normal("item_emb", (cfg.n_items, d), ("item_vocab", "rs_feat"),
                 stddev=0.02)
        b.sub("gru1", *_init_gru(gen, d, g, cfg.param_dtype, "gru1"))
        b.sub("augru", *_init_gru(gen, g, g, cfg.param_dtype, "augru"))
        b.normal("att_w", (g, d), ("rs_in", "rs_out"))  # attention bilinear
        mlp_dims = (g + d,) + cfg.mlp_dims + (1,)
        b.sub("mlp", *_mlp_tower(gen, mlp_dims, cfg.param_dtype))
        b.normal("retrieval_proj", (g, d), ("rs_in", "rs_out"))
        return b.build()

    def _interest(self, params, batch):
        emb = _rows(params["item_emb"], batch["hist"])     # [B,S,d]
        m = batch["hist_mask"].to(torch.float32)
        h = torch.zeros((emb.shape[0], self.cfg.gru_dim), dtype=torch.float32,
                        device=emb.device)
        hs = []
        for t in range(emb.shape[1]):
            h_new = _gru_cell(params["gru1"], "gru1", emb[:, t], h)
            h = torch.where(m[:, t, None] > 0, h_new, h)
            hs.append(h)
        return emb, torch.stack(hs, dim=1), m            # hs [B,S,g]

    def _evolve(self, params, hs, tgt_emb, m):
        """AUGRU: attention-scaled update gate. The three-operand einsum may
        contract in another order than the reference's: floats only."""
        att = torch.einsum("bsg,gd,bd->bs", hs, params["att_w"], tgt_emb)
        att = torch.softmax(torch.where(m > 0, att, -1e30), dim=1)
        h = torch.zeros((hs.shape[0], hs.shape[2]), dtype=torch.float32,
                        device=hs.device)
        for t in range(hs.shape[1]):
            a_t = att[:, t, None]
            h_new = _gru_cell(params["augru"], "augru", hs[:, t], h)
            h_new = a_t * h_new + (1 - a_t) * h                # AUGRU
            h = torch.where(m[:, t, None] > 0, h_new, h)
        return h                                             # [B,g]

    def score(self, params, batch):
        tgt = _rows(params["item_emb"], batch["target"])
        _, hs, m = self._interest(params, batch)
        hT = self._evolve(params, hs, tgt, m)
        z = torch.cat([hT, tgt], dim=-1)
        return _mlp_run(params["mlp"], z, len(self.cfg.mlp_dims) + 1)[:, 0]

    def loss(self, params, batch):
        bce = _bce(self.score(params, batch), batch["labels"])
        return bce, {"bce": bce}

    def user_vectors(self, params, batch):
        """Retrieval approximation: project the mean interest state to item
        space (two-stage deployment standard)."""
        _, hs, m = self._interest(params, batch)
        last = torch.sum(hs * m[..., None], 1) / torch.clamp(
            torch.sum(m, 1, keepdim=True), min=1.0)
        return (last @ params["retrieval_proj"])[:, None]


# -----------------------------------------------------------------------------
# FM — factorization machine (Rendle, ICDM'10)
# -----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_fields: int = 39
    embed_dim: int = 10
    rows_per_field: int = 1_000_000
    param_dtype: torch.dtype = torch.float32


class FM(RecSysArch):
    def __init__(self, cfg: FMConfig = FMConfig(), **kw):
        self.cfg = cfg
        self.name = cfg.name
        self.embed_dim = cfg.embed_dim
        super().__init__(**kw)

    @property
    def vocab(self):
        return self.cfg.n_fields * self.cfg.rows_per_field

    def _init(self, gen):
        cfg = self.cfg
        b = L.Builder(gen, cfg.param_dtype)
        b.zeros("w0", (), ())
        b.normal("w", (self.vocab,), ("item_vocab",), stddev=0.01)
        b.normal("v", (self.vocab, cfg.embed_dim), ("item_vocab", "rs_feat"),
                 stddev=0.01)
        return b.build()

    def _field_ids(self, fields):
        off = torch.arange(self.cfg.n_fields, dtype=torch.int64,
                           device=fields.device) * self.cfg.rows_per_field
        return fields.long() + off[None, :]

    def score(self, params, batch):
        """FM via the O(nk) sum-square trick. batch['fields']: [B, n_fields]."""
        idx = self._field_ids(batch["fields"])
        lin = params["w0"] + torch.sum(params["w"][idx], dim=1)
        v = params["v"][idx]                              # [B,F,k]
        s = torch.sum(v, dim=1)
        pair = 0.5 * torch.sum(s * s - torch.sum(v * v, dim=1), dim=-1)
        return lin + pair

    def loss(self, params, batch):
        bce = _bce(self.score(params, batch), batch["labels"])
        return bce, {"bce": bce}

    def retrieve(self, params, batch, k: int = 100):
        """Candidate scoring reduces to MIPS: score(c) = const + w_c + <Σv, v_c>.
        Query = [Σ_user v ; 1]; item rows = [v_c ; w_c] over field 0, a
        [rows_per_field, k + 1] table built anew each call, as the
        reference builds it."""
        cfg = self.cfg
        v = params["v"][self._field_ids(batch["fields"])]
        s = torch.sum(v, dim=1)                            # [B,k]
        q = torch.cat([s, torch.ones((s.shape[0], 1), dtype=s.dtype,
                                     device=s.device)], dim=1)
        cand_rows = params["v"][: cfg.rows_per_field]      # field-0 items
        cand_w = params["w"][: cfg.rows_per_field][:, None]
        table = torch.cat([cand_rows, cand_w], dim=1)
        valid = torch.ones((table.shape[0],), dtype=torch.bool, device=table.device)
        return mips_topk(q, table, valid, k)

    def _fm_specs(self, B):
        return {
            "fields": spec((B, self.cfg.n_fields), torch.int32),
            "labels": spec((B,), torch.float32),
        }

    def step(self, shape_name: str) -> StepSpec:
        sh = self.shapes[shape_name]
        B = sh.dim("batch")
        axes = {"fields": ("batch", None), "labels": ("batch",)}
        if sh.kind == "train":
            return StepSpec(self.make_train_step(), self._fm_specs(B), "train", axes)
        if sh.kind == "retrieval":
            def fn(params, batch):
                return self.retrieve(params, batch)
            specs = self._fm_specs(B)
            specs.pop("labels")
            return StepSpec(fn, specs, "serve", {"fields": ("batch", None)})

        def fn(params, batch):
            return self.score(params, batch)
        return StepSpec(fn, self._fm_specs(B), "serve", axes)
