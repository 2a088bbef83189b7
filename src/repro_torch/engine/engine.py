"""Single-device composition of the engine stages.

``ingest_impl``/``query_impl`` are the stage compositions behind
``core.pipeline``'s public entry points; ``staged_ingest_impl`` is
``ingest_impl`` with admission staged, which no engine runs: it is the
decomposition the fused ``admit`` is held against. ``Engine`` wraps (cfg, state)
behind the serving protocol (``ingest``/``query``/``index_size``) that
``serve.server.RAGServer`` is built on.

Ingest costs at most one device->host sync per batch: the counters that
decide the index refresh (arrivals, rows since the last upsert) are host
integers, because the host knows which rows are live (doc id >= 0) before
it ships them; the one sync is the ring write picking out its rows.

Traced (``obs.tracer()``), each stage of ingest, publish, the two-stage
query and set-up is an ``engine.*`` span (``obs/trace.py`` names them).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import index as index_lib, pipeline
from repro_torch.engine import stages
from repro_torch.kernels.common import host_to_device, resolve_device
from repro_torch.obs.trace import NULL_SPAN
from repro_torch.store import docstore


class ServingSnapshot(NamedTuple):
    """The queryable state an engine publishes: clones, so later ingest
    (which writes the live state in place) never tears a snapshot."""

    index: index_lib.FlatIndex
    route_labels: torch.Tensor   # [bmax] i32 slot -> cluster (-1 dead)
    store: docstore.DocStore
    version: int = 0
    published_at: float = 0.0


def _host_ids(doc_ids) -> np.ndarray:
    if torch.is_tensor(doc_ids):
        doc_ids = doc_ids.cpu()
    return np.asarray(doc_ids, dtype=np.int32)


def _device_batch(state: "pipeline.PipelineState", x, doc_ids):
    """(x [B, d] f32, doc ids [B] i32 on the state's device, host live mask)."""
    dev = state.route_labels.device
    ids_h = _host_ids(doc_ids)
    return (host_to_device(x, dev, torch.float32), host_to_device(ids_h, dev),
            ids_h >= 0)


def _after_admission(cfg: "pipeline.PipelineConfig",
                     state: "pipeline.PipelineState", x, ids, live_h, draws,
                     pre, r, keep, clus, labels, sims, v=None, vscale=None,
                     tr=None):
    """Ingest past admission: heavy-hitter counting, representatives, the
    ring write (of the admitted rows ``v``/``vscale``, or quantized by the
    store itself when None) and the periodic index refresh, each a span
    of ``tr`` (the caller's tracer, None off). Returns (new_state, info)."""
    dev = state.route_labels.device
    n_live = int(live_h.sum())
    with (tr.span("engine.count", cat="engine") if tr is not None
          else NULL_SPAN):
        hh, masked_labels, hh_info = stages.count(cfg.hh, state.hh, labels,
                                                  keep, draws, gen=state.gen)
    with tr.span("engine.reps", cat="engine") if tr is not None else NULL_SPAN:
        rep_ids, rep_sims = stages.update_representatives(
            state.rep_ids, state.rep_sims, labels, sims, ids, keep,
            cfg.clus.num_clusters)

    with (tr.span("engine.store", cat="engine") if tr is not None
          else NULL_SPAN):
        stored = keep & (hh_info["admitted"] | hh_info["hit"])
        # arrival index among live rows (== arange(B) for an unpadded batch)
        stamps_h = (state.arrivals + np.cumsum(live_h) - 1).astype(np.int32)
        store = stages.store_write(cfg.store, state.store, x, labels, stored,
                                   ids, host_to_device(stamps_h, dev),
                                   v=v, vscale=vscale)

    since = state.since_upsert + n_live
    refresh = since >= cfg.update_interval
    new_index, route_labels = state.index, state.route_labels
    if refresh:
        with (tr.span("engine.upsert", cat="engine") if tr is not None
              else NULL_SPAN):
            new_index, route_labels = stages.upsert_snapshot(
                cfg.index, state.index, hh, clus.centroids, rep_ids)

    new_state = pipeline.PipelineState(
        pre=pre, clus=clus, hh=hh, index=new_index, store=store,
        route_labels=route_labels, rep_ids=rep_ids, rep_sims=rep_sims,
        arrivals=state.arrivals + n_live,
        since_upsert=0 if refresh else since,
        kept=state.kept + keep.sum().to(torch.int32),
        upserts=state.upserts + int(refresh),
        gen=state.gen)
    info = {
        "relevance": r, "keep": keep, "labels": masked_labels, "sims": sims,
        "admitted": hh_info["admitted"],
        "evicted_label": hh_info["evicted_label"],
        "stored": stored, "refreshed": refresh,
        # device->host syncs this batch made (the ring write's row pick)
        "host_syncs": int(cfg.store_depth > 0),
    }
    return new_state, info


def ingest_impl(cfg: "pipeline.PipelineConfig",
                state: "pipeline.PipelineState", x, doc_ids,
                draws: dict | None = None):
    """Process one microbatch of embeddings [B, d] with host doc ids [B].

    Rows with ``doc_ids < 0`` are dead (ragged-batch padding): they never
    touch the prefilter window, centroids, counters, representatives or
    the store, and count as no arrival; the counter's per-slot random
    draws still advance. Returns (new_state, info)."""
    tr = obs.tracer()
    with tr.span("engine.h2d", cat="engine") if tr is not None else NULL_SPAN:
        x, ids, live_h = _device_batch(state, x, doc_ids)
    with (tr.span("engine.admit", cat="engine") if tr is not None
          else NULL_SPAN):
        pre, r, keep, clus, labels, sims, v, vscale = stages.admit(
            cfg.pre, cfg.clus, cfg.store, state.pre, state.clus, x, live_h)
    return _after_admission(cfg, state, x, ids, live_h, draws, pre, r, keep,
                            clus, labels, sims, v=v, vscale=vscale, tr=tr)


def staged_ingest_impl(cfg: "pipeline.PipelineConfig",
                       state: "pipeline.PipelineState", x, doc_ids,
                       draws: dict | None = None):
    """``ingest_impl`` with admission staged, as the reference's pre-fusion
    ingest (Table 18) composes it: ``screen`` -> ``assign_update``, and the
    store quantizes the rows it writes. The oracle of the fused path; same
    arguments, returns and spans (``engine.admit`` holds both stages)."""
    tr = obs.tracer()
    with tr.span("engine.h2d", cat="engine") if tr is not None else NULL_SPAN:
        x, ids, live_h = _device_batch(state, x, doc_ids)
    with (tr.span("engine.admit", cat="engine") if tr is not None
          else NULL_SPAN):
        pre, r, keep = stages.screen(cfg.pre, state.pre, x, live_h)
        clus, labels, sims = stages.assign_update(cfg.clus, state.clus, x,
                                                  keep)
    return _after_admission(cfg, state, x, ids, live_h, draws, pre, r, keep,
                            clus, labels, sims, tr=tr)


def snapshot_query_impl(cfg: "pipeline.PipelineConfig", index, route_labels,
                        store, q: torch.Tensor, k: int, *, two_stage: bool,
                        nprobe: int, depth: int | None = None):
    """Top-k over (index, route_labels, store) leaves — live state or a
    published snapshot. ``depth`` is a plan's rerank depth (None = full)."""
    if not two_stage:
        tr = obs.tracer()
        with (tr.span("engine.serve", cat="engine") if tr is not None
              else NULL_SPAN):
            scores, rows, ids = index_lib.search(cfg.index, index, q, k)
        return (scores, rows, ids,
                route_labels[rows.to(torch.int64)])
    return routed_query(cfg, index, route_labels, store, q, k, nprobe,
                        depth)[:4]


def routed_query(cfg: "pipeline.PipelineConfig", index, route_labels, store,
                 q: torch.Tensor, k: int, nprobe: int,
                 depth: int | None = None):
    """The two-stage query (the ``serve`` kernel, then the decode) over
    any ring source addressed by ``route_labels``: the store, or a hot
    tier with its remapped labels. Returns (scores, rows, doc_ids,
    clusters, routes [Q, nprobe]) — the routes the answer was served
    through. Traced: ``engine.serve`` (the kernel's wrapper and launch),
    then ``engine.decode`` (the decode's torch ops)."""
    store_depth = cfg.store_depth
    depth_eff = store_depth if depth is None else min(depth, store_depth)
    assert store_depth > 0, "two_stage requires store_depth > 0"
    assert k <= nprobe * depth_eff, "k must be <= nprobe * plan depth"
    tr = obs.tracer()
    with (tr.span("engine.serve", cat="engine") if tr is not None
          else NULL_SPAN):
        scores, pos, routes = stages.serve_topk(cfg.index, index, route_labels,
                                                store, q, k, nprobe,
                                                depth=depth_eff)
    with (tr.span("engine.decode", cat="engine") if tr is not None
          else NULL_SPAN):
        return stages.decode_rerank(store.ids, routes, scores, pos,
                                    depth_eff, nprobe,
                                    store_depth=store_depth) + (routes,)


def query_impl(cfg: "pipeline.PipelineConfig", state: "pipeline.PipelineState",
               q: torch.Tensor, k: int, *, two_stage: bool, nprobe: int,
               depth: int | None = None):
    return snapshot_query_impl(cfg, state.index, state.route_labels,
                               state.store, q, k, two_stage=two_stage,
                               nprobe=nprobe, depth=depth)


def _resolve_plan(plan, nprobe: int) -> tuple[int, int | None]:
    """Unpack a QueryPlan into (nprobe, depth); shed plans are answered by
    the serving layer and never reach an engine."""
    if plan is None:
        return nprobe, None
    assert not plan.shed, "shed plans are answered by the serving layer"
    return plan.nprobe, plan.depth


class Engine:
    """Single-device streaming engine: (cfg, PipelineState) behind the
    serving protocol. Runs on ``cuda`` unless ``device`` says otherwise
    (the given ``state``'s device wins); raises when no card is present."""

    def __init__(self, cfg: "pipeline.PipelineConfig", seed: int = 0,
                 warmup=None, state: "pipeline.PipelineState | None" = None,
                 device=None):
        self.cfg = cfg
        if state is None:
            tr = obs.tracer()
            with (tr.span("engine.init", cat="engine") if tr is not None
                  else NULL_SPAN):
                state = pipeline.init(cfg, seed, warmup, device)
        self.state = state
        self.device = resolve_device(state.route_labels.device)
        self._version = 0
        self._pub_sig = None
        self.last_publish_info: dict | None = None
        self.host_syncs = 0   # device->host syncs made by ingest

    def _queries(self, q) -> torch.Tensor:
        return host_to_device(q, self.device, torch.float32).contiguous()

    def ingest(self, x, doc_ids, draws: dict | None = None) -> dict:
        self.state, info = pipeline.ingest_batch(self.cfg, self.state, x,
                                                 doc_ids, draws)
        self.host_syncs += info["host_syncs"]
        return info

    def query(self, q, k: int = 10, *, two_stage: bool = False,
              nprobe: int = 8, plan=None):
        """Top-k over the live state; ``plan`` (a ``QueryPlan``) overrides
        (nprobe, rerank depth) for this call."""
        nprobe, depth = _resolve_plan(plan, nprobe)
        return pipeline.query(self.cfg, self.state, self._queries(q), k,
                              two_stage=two_stage, nprobe=nprobe, depth=depth)

    def prepare_publish(self) -> None:
        """Nothing to prepare: a single-device publish has no host-blocking
        part (``ShardedEngine`` reads its dirty signature here)."""

    def publish(self) -> ServingSnapshot:
        """Clone the queryable sub-state into a serving snapshot (ingest
        writes the live tensors in place, so a snapshot must not alias).
        Traced: ``engine.signature``, then ``engine.clone``."""
        st = self.state
        self._version += 1
        tr = obs.tracer()
        with (tr.span("engine.signature", cat="engine") if tr is not None
              else NULL_SPAN):
            self._update_publish_info()
        with (tr.span("engine.clone", cat="engine") if tr is not None
              else NULL_SPAN):
            return ServingSnapshot(
                index=st.index._replace(vectors=st.index.vectors.clone(),
                                        ids=st.index.ids.clone(),
                                        valid=st.index.valid.clone()),
                route_labels=st.route_labels.clone(),
                store=docstore.DocStore(*(t.clone() for t in st.store)),
                version=self._version,
                published_at=time.time())

    def _host_signature(self):
        """(cluster counts, ring write ptrs, rep ids): every
        snapshot-visible cluster change moves one of them."""
        st = self.state
        return (st.clus.counts.cpu().numpy(), st.store.ptr.cpu().numpy(),
                st.rep_ids.cpu().numpy())

    def _update_publish_info(self):
        k = self.cfg.clus.num_clusters
        sig = self._host_signature()
        if self._pub_sig is None:
            self.last_publish_info = {"mode": "full", "dirty_clusters": k,
                                      "dirty_frac": 1.0, "dirty": None}
        else:
            dirty = np.zeros((k,), bool)
            for new, old in zip(sig, self._pub_sig):
                dirty |= new != old
            idx = np.nonzero(dirty)[0].astype(np.int32)
            self.last_publish_info = {
                "mode": "delta" if idx.size else "republish",
                "dirty_clusters": int(idx.size),
                "dirty_frac": float(idx.size) / k,
                "dirty": idx,
            }
        self._pub_sig = sig

    # ------------------------------------------------------------ durability
    # PipelineState leaves index clusters on their leading axis — the axis
    # ``serve.durability`` slices dirty-cluster delta checkpoints on.
    ckpt_cluster_axis = 0

    def checkpoint_state(self):
        """The tree the durability layer checkpoints; doubles as the
        abstract tree (structure, dtypes, devices) recovery restores
        into."""
        return self.state

    def restore_state(self, state) -> None:
        """Adopt a recovered state, as ``train.checkpoint.unflatten_arrays``
        rebuilds it against ``checkpoint_state()``: on the engine's device,
        the generator included. The publish baseline resets, so the next
        publication reports mode "full" with ``dirty=None`` — the event
        the serving caches treat as clear-everything."""
        self.state = state
        self._pub_sig = None
        self.last_publish_info = None

    def query_snapshot(self, snap: ServingSnapshot, q, k: int = 10, *,
                       two_stage: bool = False, nprobe: int = 8, plan=None):
        """Same contract as ``query``, answered from a published snapshot."""
        nprobe, depth = _resolve_plan(plan, nprobe)
        return snapshot_query_impl(self.cfg, snap.index, snap.route_labels,
                                   snap.store, self._queries(q), k,
                                   two_stage=two_stage, nprobe=nprobe,
                                   depth=depth)

    def routed_query_snapshot(self, snap: ServingSnapshot, q, k: int,
                              nprobe: int, depth: int | None = None):
        """The fused two-stage query on a published snapshot: (scores,
        rows, doc_ids, clusters, routes [Q, nprobe])."""
        return routed_query(self.cfg, snap.index, snap.route_labels,
                            snap.store, self._queries(q), k, nprobe, depth)

    def index_size(self) -> int:
        return int(index_lib.size(self.state.index))

    def device_counters(self) -> dict:
        """The pipeline counters as ONE small device->host transfer."""
        vec = stages.pipeline_counters(self.cfg, self.state).cpu().numpy()
        return stages.decode_pipeline_counters(vec[None])

    def state_memory_bytes(self) -> int:
        return pipeline.state_memory_bytes(self.cfg)

    def store_bytes_per_device(self) -> int:
        return docstore.memory_bytes(self.cfg.store)
