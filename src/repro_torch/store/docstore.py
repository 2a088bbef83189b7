"""Streaming document store: per-cluster ring buffers of admitted docs.

Per cluster the store keeps the ``depth`` most recently admitted
documents — embedding (fp32, or int8 with one fp32 scale per slot), doc
id and arrival stamp — as ``[k, depth, ...]`` tensors. ``add_batch`` is a
ring scatter with sequential semantics: the final state equals writing
the batch one document at a time.

Unlike the reference's immutable arrays, ``add_batch`` writes the ring
tensors in place (the caller's state is donated, as ``jit`` donates it in
the reference), so a full-size store is never copied per batch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels.common import l2_normalize
from repro_torch.store import quant

STORE_DTYPES = ("fp32", "int8")


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    num_clusters: int = 100
    depth: int = 8          # ring slots per cluster (0 disables the store)
    dim: int = 384
    normalize: bool = True  # store unit vectors -> cosine rerank
    store_dtype: str = "fp32"   # "fp32" | "int8" ring embedding precision

    def __post_init__(self):
        assert self.store_dtype in STORE_DTYPES, self.store_dtype

    @property
    def emb_dtype(self) -> torch.dtype:
        return torch.int8 if self.store_dtype == "int8" else torch.float32

    @property
    def emb_itemsize(self) -> int:
        return 1 if self.store_dtype == "int8" else 4


class DocStore(NamedTuple):
    embs: torch.Tensor    # [k, depth, d] f32 or i8
    ids: torch.Tensor     # [k, depth] i32 external doc id (-1 = empty slot)
    stamps: torch.Tensor  # [k, depth] i32 arrival index at admission
    ptr: torch.Tensor     # [k] i32 monotone write counter (slot = ptr % depth)
    scales: torch.Tensor  # [k, depth] f32 per-slot dequantization scale


def init(cfg: StoreConfig, device) -> DocStore:
    k, depth = cfg.num_clusters, cfg.depth
    return DocStore(
        embs=torch.zeros((k, depth, cfg.dim), dtype=cfg.emb_dtype,
                         device=device),
        ids=torch.full((k, depth), -1, dtype=torch.int32, device=device),
        stamps=torch.full((k, depth), -1, dtype=torch.int32, device=device),
        ptr=torch.zeros((k,), dtype=torch.int32, device=device),
        scales=torch.zeros((k, depth), dtype=torch.float32, device=device),
    )


def add_batch(
    cfg: StoreConfig, store: DocStore, x: torch.Tensor, labels: torch.Tensor,
    admit: torch.Tensor, doc_ids: torch.Tensor, stamps: torch.Tensor,
    v: torch.Tensor | None = None, vscale: torch.Tensor | None = None,
) -> DocStore:
    """Ring-write the admitted documents of one microbatch (in place).

    x: [B, d]; labels: [B] i32; admit: [B] bool; doc_ids/stamps: [B] i32.
    Per cluster, admitted docs take the next ring slots in arrival order;
    when more than ``depth`` docs of one cluster arrive in one batch only
    the last ``depth`` survive, so no two writes share a slot. The rows
    that are written are picked out before ``index_put_`` (torch has no
    "drop" scatter mode): that is one device->host sync.

    ``v``/``vscale`` are pre-quantized rows in the store dtype (as the
    admit kernel emits them); without them the rows are normalized and
    quantized here, with identical results.
    """
    if cfg.depth == 0:
        return store
    k, depth = cfg.num_clusters, cfg.depth
    if v is None:
        v = l2_normalize(x) if cfg.normalize else x.to(torch.float32)
        if cfg.store_dtype == "int8":
            v, vscale = quant.quantize_int8(v, dim=-1)
        else:
            vscale = torch.ones((x.shape[0],), dtype=torch.float32,
                                device=x.device)
    else:
        assert vscale is not None, "pre-quantized rows require their scales"
        assert v.dtype == cfg.emb_dtype, (v.dtype, cfg.emb_dtype)

    dev = x.device
    lbl = torch.where(admit, labels, k).to(torch.int64)   # k = drop bucket
    onehot = lbl[:, None] == torch.arange(k, device=dev)[None, :]
    occ = torch.cumsum(onehot, dim=0, dtype=torch.int32)  # [B, k]
    per_cluster = occ[-1]                                 # [k] admits
    lbl_c = torch.clamp(lbl, max=k - 1)
    rank = torch.gather(occ, 1, lbl_c[:, None])[:, 0] - 1
    # survivors: the last `depth` admits of each cluster in this batch
    write = admit & (per_cluster[lbl_c] - rank <= depth)
    slot = torch.remainder(store.ptr[lbl_c].to(torch.int64) + rank, depth)

    sel = torch.nonzero(write).squeeze(1)   # the one device->host sync
    r, s = lbl[sel], slot[sel]
    store.embs[r, s] = v[sel]
    store.ids[r, s] = doc_ids[sel].to(torch.int32)
    store.stamps[r, s] = stamps[sel].to(torch.int32)
    store.scales[r, s] = vscale[sel]
    return store._replace(ptr=store.ptr + per_cluster)


def merge_stacked(cfg: StoreConfig, stores: DocStore) -> DocStore:
    """Exact merge of S shard-local stores (leaves stacked on a leading
    shard axis) into the store one sequential writer would hold.

    Per cluster, the union of the shards' entries is ordered by arrival
    stamp, dead entries first and ties by (shard, slot) through a stable
    ascending sort, and the newest ``depth`` survive; the write counter
    is the shards' sum, and the entries are placed so that the newest
    sits at slot ``(ptr - 1) % depth``. int8 rows and their scales are
    gathered, never re-quantized. The cluster count is read from the
    leaves, so a row subset (the dirty clusters of a delta publish)
    merges the same way."""
    if cfg.depth == 0:
        return DocStore(*(t[0] for t in stores))
    S, k = stores.ids.shape[0], stores.ids.shape[1]
    depth, d = cfg.depth, cfg.dim
    flat = S * depth

    # [k, S*depth] entry tables, shard-major (the tie-break order)
    ids = stores.ids.transpose(0, 1).reshape(k, flat)
    stamps = stores.stamps.transpose(0, 1).reshape(k, flat)
    scales = stores.scales.transpose(0, 1).reshape(k, flat)
    embs = stores.embs.transpose(0, 1).reshape(k, flat, d)

    key = torch.where(ids >= 0, stamps, -(2**31))         # dead sort first
    order = torch.argsort(key, dim=1, stable=True)[:, -depth:].to(torch.int64)
    sel_ids = torch.gather(ids, 1, order)
    sel_stamps = torch.gather(stamps, 1, order)
    sel_scales = torch.gather(scales, 1, order)
    sel_embs = torch.gather(embs, 1, order[..., None].expand(-1, -1, d))
    live = sel_ids >= 0

    # window position i -> slot (ptr - depth + i) % depth, gathered as
    # out[:, s] = window[:, (s - ptr) % depth]
    ptr = stores.ptr[0]
    for s in range(1, S):
        ptr = ptr + stores.ptr[s]
    s_idx = torch.arange(depth, device=ptr.device)[None, :]
    i = torch.remainder(s_idx - ptr[:, None].to(torch.int64), depth)
    embs_out = torch.where(live[..., None], sel_embs,
                           torch.zeros((), dtype=sel_embs.dtype,
                                       device=sel_embs.device))
    return DocStore(
        embs=torch.gather(embs_out, 1, i[..., None].expand(-1, -1, d)),
        ids=torch.gather(torch.where(live, sel_ids, -1), 1, i),
        stamps=torch.gather(torch.where(live, sel_stamps, -1), 1, i),
        ptr=ptr.to(torch.int32),
        scales=torch.gather(torch.where(live, sel_scales, 0.0), 1, i))


def scatter_rows(store: DocStore, rows: DocStore, idx: torch.Tensor) -> DocStore:
    """``store`` with the per-cluster ``rows`` (a DocStore whose leading
    axis enumerates the clusters ``idx`` names) written in, as new
    tensors: the previous snapshot stays as it was. Out-of-range ``idx``
    entries are dropped (delta publishes scatter only the dirty clusters
    a store shard owns)."""
    k = store.ids.shape[0]
    idx = idx.to(store.ids.device, torch.int64)
    keep = torch.nonzero((idx >= 0) & (idx < k)).squeeze(1)
    at = idx[keep]
    out = []
    for a, r in zip(store, rows):
        a = a.clone()
        a[at] = r.to(a.device)[keep]
        out.append(a)
    return DocStore(*out)


def shard_slice(cfg: StoreConfig, store: DocStore, shard: int,
                n_shards: int) -> DocStore:
    """Cluster range ``[shard*k/n, (shard+1)*k/n)`` of a full store (a
    view) — one store shard when rings are cluster-sharded."""
    assert cfg.num_clusters % n_shards == 0, \
        "num_clusters must divide evenly across store shards"
    kl = cfg.num_clusters // n_shards
    return DocStore(*(t[shard * kl:(shard + 1) * kl] for t in store))


def gather_rows(store, idx: torch.Tensor) -> DocStore:
    """Cluster rows ``idx`` (global ids, on the device the result goes
    to) of a DocStore, or of a cluster-sharded store: a tuple of DocStore
    shards in shard order, shard m holding clusters ``[m*kl, (m+1)*kl)``.
    Each shard gives the rows it owns; exact copies either way."""
    idx = idx.to(torch.int64)
    if isinstance(store, DocStore):
        return DocStore(*(t.index_select(0, idx.to(t.device)) for t in store))
    kl = store[0].ids.shape[0]
    out = [torch.empty((idx.shape[0],) + t.shape[1:], dtype=t.dtype,
                       device=idx.device) for t in store[0]]
    for m, shard in enumerate(store):
        at = torch.nonzero(torch.div(idx, kl, rounding_mode="floor") == m
                           ).squeeze(1)
        rows = idx[at] - m * kl
        for o, t in zip(out, shard):
            o[at] = t.index_select(0, rows.to(t.device)).to(o.device)
    return DocStore(*out)


def dequantize(cfg: StoreConfig, store: DocStore) -> torch.Tensor:
    """[k, depth, d] f32 embeddings (``q * scale`` for int8 stores)."""
    if cfg.store_dtype == "int8":
        return quant.dequantize_int8(store.embs, store.scales[..., None])
    return store.embs


def live_mask(store: DocStore) -> torch.Tensor:
    """[k, depth] bool — slots holding a real document."""
    return store.ids >= 0


def size(store: DocStore) -> torch.Tensor:
    return torch.sum(live_mask(store).to(torch.int32))


def memory_bytes(cfg: StoreConfig) -> int:
    """Resident bytes of the store state: ``dim * itemsize`` per slot plus
    12 bytes (id, stamp, scale), plus the write counters."""
    k, depth = cfg.num_clusters, cfg.depth
    per_slot = cfg.dim * cfg.emb_itemsize + 4 + 4 + 4
    return k * depth * per_slot + k * 4
