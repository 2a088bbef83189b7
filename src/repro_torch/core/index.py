"""Retrieval indices (paper §Dynamic Knowledge Base Reconstruction).

``FlatIndex`` — the Faiss IndexFlatIP analogue: a dense ``[cap, d]``
matrix with a validity mask and per-row doc ids. Queries go through the
``mips`` kernel. ``upsert`` writes rows in place (the caller's index is
donated); published snapshots are clones, so a query on a snapshot never
sees a torn row.

``IVFPQIndex`` — the Faiss-IVFPQ-incremental baseline: a coarse quantizer
(k-means over ``nlist`` cells) and product quantization (``m`` subspaces
x 256 codewords) with asymmetric LUT scoring and incremental ring-buffer
adds. The reference computes it in plain array ops with no kernel of its
own, and so does the port: the LUT einsum, a gather, and ``stable_topk``
for both top-ks (ties to the lowest index). Lloyd's sums are the
deterministic one-hot product (``clustering._segment_sums``)."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.clustering import _segment_sums, kmeans_plus_plus
from repro_torch.kernels.common import (NEG_INF, l2_normalize, l2_normalize_queries,
                                        stable_topk)
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


# ----------------------------------------------------------------------------
# IVF-PQ incremental baseline (the Faiss IVFPQ analogue)
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class IVFPQConfig:
    capacity: int = 4096
    dim: int = 384
    nlist: int = 64       # coarse cells
    m: int = 8            # PQ subspaces (dim % m == 0)
    nbits: int = 8        # codewords per subspace = 2**nbits
    nprobe: int = 8


class IVFPQIndex(NamedTuple):
    coarse: torch.Tensor     # [nlist, d] cell centroids
    codebooks: torch.Tensor  # [m, 2**nbits, d/m]
    codes: torch.Tensor      # [cap, m] uint8 PQ codes
    cell: torch.Tensor       # [cap] i32 coarse assignment (-1 = never added)
    ids: torch.Tensor        # [cap] i32
    valid: torch.Tensor      # [cap] bool
    write_ptr: int           # ring position of the next add (host)


def _lloyd_step(x: torch.Tensor, c: torch.Tensor, lbl: torch.Tensor) -> torch.Tensor:
    """One Lloyd update: each centroid with members becomes their mean."""
    k = c.shape[0]
    sums, cnts = _segment_sums(k, x, lbl, torch.ones_like(lbl, dtype=torch.bool))
    return torch.where((cnts > 0)[:, None],
                       sums / torch.clamp(cnts, min=1.0)[:, None], c)


def _nearest_code(sub: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """argmin over codewords of the squared distance, the reference's
    expansion ``|s|^2 - 2 s.c + |c|^2`` (ties to the lowest codeword)."""
    d2 = (torch.sum(sub * sub, dim=1, keepdim=True) - 2 * sub @ cb.T
          + torch.sum(cb * cb, dim=1)[None])
    return torch.argmin(d2, dim=1)


def ivfpq_train(cfg: IVFPQConfig, gen: torch.Generator, sample: torch.Tensor,
                draws: dict | None = None) -> IVFPQIndex:
    """Train the coarse and PQ codebooks on ``sample`` [n, d] by a few Lloyd
    iterations, on the sample's device. ``draws`` = {"picks": [nlist] the
    coarse k-means++ rows, "choices": [m, 2**nbits] each subspace's
    initial codeword rows}; drawn from ``gen`` when None."""
    dev = sample.device
    xs = l2_normalize(sample)
    n = xs.shape[0]
    dsub, ncode = cfg.dim // cfg.m, 2 ** cfg.nbits
    picks = choices = None
    if draws is not None:
        picks, choices = draws["picks"], draws["choices"]
    coarse = kmeans_plus_plus(gen, xs, cfg.nlist, picks)
    for _ in range(4):   # Lloyd refinement
        coarse = _lloyd_step(xs, coarse, torch.argmax(xs @ coarse.T, dim=1))

    resid = xs - coarse[torch.argmax(xs @ coarse.T, dim=1)]
    subs = resid.reshape(n, cfg.m, dsub).transpose(0, 1)      # [m, n, dsub]
    if choices is None:
        choices = torch.randint(0, n, (cfg.m, ncode), generator=gen, device=dev)
    choices = torch.as_tensor(choices, dtype=torch.int64, device=dev)
    books = []
    for i in range(cfg.m):
        sub = subs[i]
        cb = sub[choices[i]]
        for _ in range(4):
            cb = _lloyd_step(sub, cb, _nearest_code(sub, cb))
        books.append(cb)
    return IVFPQIndex(
        coarse=coarse,
        codebooks=torch.stack(books),
        codes=torch.zeros((cfg.capacity, cfg.m), dtype=torch.uint8, device=dev),
        cell=torch.full((cfg.capacity,), -1, dtype=torch.int32, device=dev),
        ids=torch.full((cfg.capacity,), -1, dtype=torch.int32, device=dev),
        valid=torch.zeros((cfg.capacity,), dtype=torch.bool, device=dev),
        write_ptr=0)


def ivfpq_add(cfg: IVFPQConfig, index: IVFPQIndex, x: torch.Tensor,
              ids: torch.Tensor) -> IVFPQIndex:
    """Incremental add of [n, d] (n <= capacity): ring-buffer overwrite
    past capacity, in place (the caller's index is donated)."""
    n = x.shape[0]
    if n > cfg.capacity:
        raise ValueError(f"an add of {n} rows overruns the ring of {cfg.capacity}")
    xs = l2_normalize(x)
    cell = torch.argmax(xs @ index.coarse.T, dim=1)
    resid = xs - index.coarse[cell]
    subs = resid.reshape(n, cfg.m, cfg.dim // cfg.m)
    codes = torch.stack([_nearest_code(subs[:, i], index.codebooks[i])
                         for i in range(cfg.m)], dim=1)
    rows = torch.remainder(torch.arange(index.write_ptr, index.write_ptr + n,
                                        device=x.device), cfg.capacity)
    index.codes[rows] = codes.to(torch.uint8)
    index.cell[rows] = cell.to(torch.int32)
    index.ids[rows] = ids.to(torch.int32)
    index.valid[rows] = True
    return index._replace(write_ptr=(index.write_ptr + n) % cfg.capacity)


def ivfpq_search(cfg: IVFPQConfig, index: IVFPQIndex, queries: torch.Tensor,
                 k: int):
    """Asymmetric-distance search: the top-``nprobe`` coarse cells, then
    each row's score = its cell's coarse score + the sum of its codes' LUT
    entries; rows outside the probed cells, never added or invalid score
    NEG_INF. Returns (scores [Q, k], rows [Q, k] i32, ids [Q, k])."""
    q = l2_normalize_queries(queries)                        # [Q, d]
    Q, cap = q.shape[0], index.codes.shape[0]
    coarse_sim = q @ index.coarse.T                          # [Q, nlist]
    _, probe = stable_topk(coarse_sim, cfg.nprobe)           # [Q, nprobe]
    qsub = q.reshape(Q, cfg.m, cfg.dim // cfg.m)
    # LUT: inner products of each query subvector with every codeword
    lut = torch.einsum("qmd,mcd->qmc", qsub, index.codebooks)   # [Q, m, ncode]
    codes = index.codes.to(torch.int64)[None, :, :, None].expand(Q, cap, cfg.m, 1)
    code_scores = torch.sum(torch.gather(
        lut[:, None].expand(Q, cap, cfg.m, lut.shape[2]), 3, codes)[..., 0], dim=2)
    # rows never validly added carry cell -1: masked out of the coarse gather
    cell_live = index.cell >= 0
    cell_sim = coarse_sim[:, torch.clamp(index.cell, min=0).to(torch.int64)]
    full = code_scores + torch.where(cell_live[None, :], cell_sim, NEG_INF)
    in_probe = torch.any(index.cell[None, :, None] == probe[:, None, :], dim=-1)
    ok = in_probe & index.valid[None, :] & cell_live[None, :]
    scores, rows = stable_topk(torch.where(ok, full, NEG_INF), k)
    return scores, rows.to(torch.int32), index.ids[rows]

