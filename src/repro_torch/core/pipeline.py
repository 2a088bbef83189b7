"""The Streaming RAG pipeline (paper Algorithm 1), per microbatch.

    x_t --Pre-filter--> x̃_t --Cluster--> μ_j* --Heavy-Hitter--> C_t
        --Index-Update--> I_t

State is one ``PipelineState`` of tensors on one device plus the host
integers the host already knows (arrival counts, the index version). The
per-stage implementation lives in ``repro_torch.engine`` (``stages.py``
composed by ``engine.py``); this module keeps the public config/state
types and the entry points.

``ingest_batch`` donates its input state: ring buffers, the PCA window
and the index are written in place, as ``jit`` donates the state in the
reference. Keep a ``clone`` (``Engine.publish``) of what must not change.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core import clustering, heavy_hitter, index as index_lib, prefilter
from repro_torch.kernels.common import resolve_device
from repro_torch.obs.trace import NULL_SPAN
from repro_torch.store import docstore


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Defaults follow paper Table 2."""

    pre: prefilter.PrefilterConfig = prefilter.PrefilterConfig()
    clus: clustering.ClusterConfig = clustering.ClusterConfig()
    hh: heavy_hitter.HHConfig = heavy_hitter.HHConfig()
    update_interval: int = 1000   # index upsert every N arrivals
    store_depth: int = 0          # docs per cluster ring (0 = no store)
    store_dtype: str = "fp32"     # "fp32" | "int8" ring precision

    @property
    def index(self) -> index_lib.IndexConfig:
        return index_lib.IndexConfig(capacity=self.hh.bmax(),
                                     dim=self.clus.dim, normalize=True)

    @property
    def store(self) -> docstore.StoreConfig:
        return docstore.StoreConfig(
            num_clusters=self.clus.num_clusters, depth=self.store_depth,
            dim=self.clus.dim, normalize=True, store_dtype=self.store_dtype)

    def __post_init__(self):
        assert self.pre.dim == self.clus.dim, "prefilter/cluster dim mismatch"
        assert self.store_depth >= 0
        assert self.store_dtype in docstore.STORE_DTYPES, self.store_dtype


class PipelineState(NamedTuple):
    pre: prefilter.PrefilterState
    clus: clustering.ClusterState
    hh: heavy_hitter.HHState
    index: index_lib.FlatIndex
    store: docstore.DocStore
    # [bmax] i32 cluster label per index slot, snapshotted at upsert time:
    # routing reads THIS, not the live counter labels
    route_labels: torch.Tensor
    rep_ids: torch.Tensor      # [k] i32 freshest member doc id per cluster
    rep_sims: torch.Tensor     # [k] f32
    arrivals: int              # live docs seen (stream offset)
    since_upsert: int
    kept: torch.Tensor         # i32 scalar: passed the pre-filter
    upserts: int               # index refresh batches
    gen: torch.Generator       # heavy-hitter draws


def init(cfg: PipelineConfig, seed: int = 0, warmup=None,
         device=None) -> PipelineState:
    """Fresh state on ``device`` (``cuda`` unless given; raises when no
    card is present). ``warmup`` [m, d] seeds k-means++ (traced: the
    ``engine.kmeans_pp`` span) and the basis."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    warm = (None if warmup is None else
            torch.as_tensor(warmup, dtype=torch.float32, device=dev))
    if warm is not None:
        tr = obs.tracer()
        with (tr.span("engine.kmeans_pp", cat="engine") if tr is not None
              else NULL_SPAN):
            clus = clustering.init_from_buffer(cfg.clus, gen, warm)
    else:
        clus = clustering.init(cfg.clus, gen)
    k = cfg.clus.num_clusters
    return PipelineState(
        pre=prefilter.init(cfg.pre, gen, warm, dev),
        clus=clus,
        hh=heavy_hitter.init(cfg.hh, dev),
        index=index_lib.init(cfg.index, dev),
        store=docstore.init(cfg.store, dev),
        route_labels=torch.full((cfg.hh.bmax(),), -1, dtype=torch.int32,
                                device=dev),
        rep_ids=torch.full((k,), -1, dtype=torch.int32, device=dev),
        rep_sims=torch.full((k,), -torch.inf, dtype=torch.float32,
                            device=dev),
        arrivals=0, since_upsert=0,
        kept=torch.zeros((), dtype=torch.int32, device=dev),
        upserts=0, gen=gen)


def ingest_batch(cfg: PipelineConfig, state: PipelineState, x, doc_ids,
                 draws: dict | None = None):
    """One microbatch: embeddings [B, d], host doc ids [B] (-1 = dead
    padding row). ``draws`` are the heavy-hitter's per-arrival random
    numbers (see ``heavy_hitter.update_batch``); None draws them from
    ``state.gen``. Returns (new_state, info)."""
    from repro_torch.engine.engine import ingest_impl

    return ingest_impl(cfg, state, x, doc_ids, draws)


def ingest_stream(cfg: PipelineConfig, state: PipelineState, chunks,
                  chunk_ids) -> PipelineState:
    """Ingest [n_batches, B, d] (+ ids [n_batches, B]) batch by batch."""
    for xb, ib in zip(chunks, chunk_ids):
        state, _ = ingest_batch(cfg, state, xb, ib)
    return state


def query(cfg: PipelineConfig, state: PipelineState, q: torch.Tensor,
          k: int = 10, *, two_stage: bool = False, nprobe: int = 8,
          depth: int | None = None):
    """Top-k: (scores [Q, k], rows [Q, k], doc_ids [Q, k], clusters [Q, k]).

    two_stage=False — prototype-only: rows are index slots, doc_ids the
    clusters' representative docs. two_stage=True — the index routes each
    query to ``nprobe`` clusters whose rings are reranked exactly; rows
    are flat store positions cluster*store_depth + slot. ``depth`` clips
    the rerank to the first ``depth`` ring slots (None = full ring)."""
    from repro_torch.engine.engine import query_impl

    return query_impl(cfg, state, q, k, two_stage=two_stage, nprobe=nprobe,
                      depth=depth)


def state_memory_bytes(cfg: PipelineConfig) -> int:
    """Peak resident bytes of the pipeline state (paper's memory metric)."""
    d = cfg.clus.dim
    k = cfg.clus.num_clusters
    bmax = cfg.hh.bmax()
    pre_w = cfg.pre.window if cfg.pre.basis == "adaptive" else 1
    n = cfg.pre.num_vectors
    cms = cfg.hh.cms_depth * cfg.hh.cms_width * 4
    pre_b = (n * d + pre_w * d) * 4
    clus_b = (k * d + k) * 4
    hh_b = bmax * 8 + cms
    idx_b = index_lib.memory_bytes(cfg.index) + bmax * 4  # + route labels
    rep_b = k * 8
    store_b = docstore.memory_bytes(cfg.store)
    return pre_b + clus_b + hh_b + idx_b + rep_b + store_b


def budget_to_config(memory_mb: float, dim: int = 384,
                     base: PipelineConfig | None = None) -> PipelineConfig:
    """Map a memory budget to (k, B) as the paper's sweep does (Table 6):
    ~80% to cluster prototypes (each with its full doc ring), ~20% to
    index + counters."""
    base = base or PipelineConfig()
    budget = memory_mb * 1e6
    per_proto = dim * 4 * 2 + 24          # centroid + index row + bookkeeping
    per_cluster = per_proto + docstore.memory_bytes(docstore.StoreConfig(
        num_clusters=1, depth=base.store_depth, dim=dim,
        store_dtype=base.store_dtype))
    k = max(16, int(budget * 0.8 / per_cluster))
    b = max(16, min(k, int(budget * 0.2 / per_proto)))
    return dataclasses.replace(
        base,
        pre=dataclasses.replace(base.pre, dim=dim),
        clus=dataclasses.replace(base.clus, num_clusters=k, dim=dim),
        hh=dataclasses.replace(base.hh, capacity=b, max_capacity=None),
    )
