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
