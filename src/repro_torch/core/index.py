"""Flat incremental-upsert prototype index (paper §Dynamic Knowledge Base
Reconstruction; the Faiss IndexFlatIP analogue): a dense ``[cap, d]``
matrix with a validity mask and per-row doc ids. Queries go through the
``mips`` kernel. ``upsert`` writes rows in place (the caller's index is
donated); published snapshots are clones, so a query on a snapshot never
sees a torn row. IVF-PQ waits for the port's baselines slice."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels.common import l2_normalize, l2_normalize_queries
from repro_torch.kernels.mips.ops import mips_topk


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    capacity: int = 256
    dim: int = 384
    normalize: bool = True     # store unit vectors -> cosine MIPS


class FlatIndex(NamedTuple):
    vectors: torch.Tensor   # [cap, d] f32
    ids: torch.Tensor       # [cap] i32 external id per row (-1 = none)
    valid: torch.Tensor     # [cap] bool
    version: int            # bumped on every upsert batch


def init(cfg: IndexConfig, device) -> FlatIndex:
    return FlatIndex(
        vectors=torch.zeros((cfg.capacity, cfg.dim), dtype=torch.float32,
                            device=device),
        ids=torch.full((cfg.capacity,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((cfg.capacity,), dtype=torch.bool, device=device),
        version=0)


def upsert(cfg: IndexConfig, index: FlatIndex, rows: torch.Tensor,
           vectors: torch.Tensor, ids: torch.Tensor,
           valid: torch.Tensor) -> FlatIndex:
    """Write ``vectors`` into slots ``rows``; rows with valid=False are
    tombstoned. rows [m] (distinct); vectors [m, d]; ids [m] i32; valid
    [m] bool."""
    v = l2_normalize(vectors) if cfg.normalize else vectors.to(torch.float32)
    r = rows.to(torch.int64)
    index.vectors[r] = v
    index.ids[r] = torch.where(valid, ids, -1).to(torch.int32)
    index.valid[r] = valid
    return index._replace(version=index.version + 1)


def search(cfg: IndexConfig, index: FlatIndex, queries: torch.Tensor, k: int):
    """Top-k MIPS over valid rows: (scores [Q, k], rows [Q, k], ids [Q, k])."""
    q = l2_normalize_queries(queries) if cfg.normalize else \
        queries.to(torch.float32).contiguous()
    scores, rows = mips_topk(q, index.vectors, index.valid, k)
    return scores, rows, index.ids[rows.to(torch.int64)]


def size(index: FlatIndex) -> torch.Tensor:
    return torch.sum(index.valid.to(torch.int32))


def memory_bytes(cfg: IndexConfig) -> int:
    """Resident bytes of the index state (for the memory-budget benches)."""
    return cfg.capacity * cfg.dim * 4 + cfg.capacity * (4 + 1) + 4
