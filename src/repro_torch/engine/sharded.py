"""ShardedEngine: the streaming engine over a ``D x M`` mesh of devices.

One process drives every shard (the reference's single-controller SPMD
program, with the collectives written out in ``distributed.collectives``):

  * ingest    — the stream is split contiguously over the ``data`` axis;
                data shard d runs the single-device step
                (``engine.ingest_impl``: the admit and heavy-hitter
                kernels) on its sub-batch, on device ``mesh[d, 0]``. The
                reference replicates that step over ``model``; here it
                runs once. Shard-local states are never overwritten by a
                reconcile, so repeated merges stay exact.
  * reconcile — every ``reconcile_every`` batches the shards publish one
                consistent snapshot: counters label-union merged,
                centroids count-weighted, representatives by recency, the
                rings exactly (newest ``depth`` per cluster across
                shards); the prototype index and the routing table are
                rebuilt by ``stages.upsert_snapshot``. The merge runs
                once, on ``mesh[0, 0]``, and the store is cut into
                ``M`` cluster ranges, store shard m on ``mesh[0, m]``.
  * serve     — the (small) prototype index is replicated; two-stage
                queries run the ``serve`` kernel once per store shard
                under a localized label table and merge with the
                single-device tie-break (``distributed_serve_topk``);
                ``staged=True`` routes once (``mips``) and reranks once
                per store shard (``distributed_rerank_topk``).

Publication modes: ``full`` rebuilds from every shard's state; ``delta``
diffs the host signature (per-shard cluster counts, ring write counters,
representatives) against the last publish, re-merges only the dirty
clusters' rows into the previous snapshot, and falls back to a full
rebuild past ``delta_max_frac`` of the clusters. Both publish the same
snapshot bit for bit. The reference buckets the dirty count to powers of
two to bound its compiles; the port compiles nothing per shape and takes
the dirty rows as they are.

``reconcile_states`` (per-shard states in, a snapshot with the full
store out) is the merge every path composes, and the host-side oracle.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import clustering, index as index_lib, pipeline
from repro_torch.distributed.collectives import (distributed_rerank_topk,
                                                 distributed_serve_topk,
                                                 merge_clusters, merge_counters)
from repro_torch.engine import stages
from repro_torch.engine.engine import (ServingSnapshot, _host_ids,
                                       _resolve_plan, ingest_impl)
from repro_torch.kernels.common import host_to_device, l2_normalize_queries
from repro_torch.launch.mesh import Mesh, describe
from repro_torch.store import docstore

__all__ = ["ServingSnapshot", "ShardedEngine", "reconcile_states",
           "reconcile_stacked_states", "stack_states", "state_to",
           "unstack_state"]


# ----------------------------------------------------------- state layout
def state_to(tree, device):
    """A copy of a state tree on ``device`` (host ints and generators are
    carried as they are)."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(state_to(v, device) for v in tree))
    if torch.is_tensor(tree):
        return tree.to(device, copy=True)
    return tree


def stack_states(states: list, device):
    """The shards' states as one tree with a leading shard axis (the
    checkpoint layout: per-cluster leaves index clusters on axis 1):
    tensors stacked on ``device``; host ints and generators become
    tuples, one entry a shard."""
    first = states[0]
    if hasattr(first, "_fields"):
        return type(first)(*(stack_states([s[i] for s in states], device)
                             for i in range(len(first))))
    if torch.is_tensor(first):
        return torch.stack([s.to(device) for s in states])
    return tuple(states)


def unstack_state(stacked, shard: int, device):
    """Shard ``shard``'s own state out of ``stack_states``' layout, as
    new tensors on ``device``."""
    if hasattr(stacked, "_fields"):
        return type(stacked)(*(unstack_state(v, shard, device)
                               for v in stacked))
    if torch.is_tensor(stacked):
        return stacked[shard].to(device, copy=True)
    return stacked[shard]


def _shard_generator(seed: int, shard: int, device) -> torch.Generator:
    """Data shard ``shard``'s generator for its heavy-hitter draws: shards
    share one init and diverge only through their sub-streams and these
    draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & 0xFFFFFFFF) << 24) | (0x5A << 16) | shard)
    return gen


# ---------------------------------------------------------------- merges
def _merge_cluster_rows(cfg: pipeline.PipelineConfig, states: list, device,
                        rows: torch.Tensor | None = None):
    """The per-cluster merges over cluster ``rows`` (None: all), on
    ``device``: (ClusterState, rep_ids, store). Every merge is
    independent per row, so a row subset merges as the whole does."""
    def pick(t):
        return t if rows is None else t[rows.to(t.device)]

    m_clus = merge_clusters([clustering.ClusterState(*map(pick, s.clus))
                             for s in states], device)
    m_rep = pick(states[0].rep_ids).to(device)
    for s in states[1:]:
        m_rep = torch.maximum(m_rep, pick(s.rep_ids).to(device))
    m_store = docstore.merge_stacked(cfg.store, stack_states(
        [docstore.DocStore(*map(pick, s.store)) for s in states], device))
    return m_clus, m_rep, m_store


def _merge_shard_states(cfg: pipeline.PipelineConfig, states: list, device):
    """The four merges behind a reconcile: (ClusterState, HHState,
    rep_ids, store), each on ``device``."""
    m_clus, m_rep, m_store = _merge_cluster_rows(cfg, states, device)
    return (m_clus, merge_counters(cfg.hh, [s.hh for s in states], device),
            m_rep, m_store)


def reconcile_states(cfg: pipeline.PipelineConfig, states: list,
                     device=None) -> ServingSnapshot:
    """Merge the shards' pipeline states into one consistent serving
    snapshot with the full (unsharded) store, on ``device`` (default:
    shard 0's). Every reconcile path composes these merges, so a sharded
    publish equals this leaf for leaf."""
    dev = states[0].route_labels.device if device is None else device
    m_clus, m_hh, m_rep, m_store = _merge_shard_states(cfg, states, dev)
    index, route_labels = stages.upsert_snapshot(
        cfg.index, index_lib.init(cfg.index, dev), m_hh, m_clus.centroids,
        m_rep)
    return ServingSnapshot(index=index, route_labels=route_labels,
                           store=m_store)


def reconcile_stacked_states(cfg: pipeline.PipelineConfig, stacked,
                             device=None) -> ServingSnapshot:
    """``reconcile_states`` over ``stack_states``' layout."""
    n = stacked.clus.counts.shape[0]
    dev = stacked.clus.counts.device if device is None else device
    return reconcile_states(cfg, [unstack_state(stacked, s, dev)
                                  for s in range(n)], dev)


# ------------------------------------------------------------------ engine
class ShardedEngine:
    """Data-sharded ingest and cluster-sharded serving over a ``Mesh``,
    behind the serving protocol of ``engine.Engine`` (ingest, publish,
    query, query_snapshot, checkpoints), so ``RAGServer`` and
    ``AsyncServer`` hold either.

    ``state`` (optional) is the initial state every data shard starts
    from (each with its own generator); by default one ``pipeline.init``
    from ``seed`` and ``warmup`` on ``mesh[0, 0]``."""

    # the stacked [S, ...] checkpoint tree indexes clusters on axis 1 —
    # the axis ``serve.durability`` slices dirty-cluster deltas on
    ckpt_cluster_axis = 1

    def __init__(self, cfg: pipeline.PipelineConfig, mesh: Mesh, seed: int = 0,
                 *, warmup=None, state: pipeline.PipelineState | None = None,
                 reconcile_every: int = 1, reconcile_mode: str = "full",
                 delta_max_frac: float = 0.5):
        self.cfg = cfg
        self.mesh = mesh
        self.n_data, self.n_model = mesh.shape
        assert cfg.clus.num_clusters % self.n_model == 0, \
            "num_clusters must divide the model axis for cluster sharding"
        assert reconcile_mode in ("full", "delta"), reconcile_mode
        self.reconcile_every = max(1, reconcile_every)
        self.reconcile_mode = reconcile_mode
        self.delta_max_frac = delta_max_frac
        self.data_devices = [mesh.device(d, 0) for d in range(self.n_data)]
        self.model_devices = [mesh.device(0, m) for m in range(self.n_model)]
        self.device = self.data_devices[0]   # merges, index, query results
        if state is None:
            state = pipeline.init(cfg, seed, warmup, self.device)
        self.shards = [
            state_to(state, dev)._replace(gen=_shard_generator(seed, d, dev))
            for d, dev in enumerate(self.data_devices)]
        self.serving: ServingSnapshot | None = None
        self._publish_version = 0
        self._batches_since_reconcile = 0
        self._ingested = 0
        # delta publication: merged (centroids, rep_ids, raw counter slot
        # labels) of the last publish, and the host signature it diffed
        self._pub_cache = None
        self._pub_sig = None
        self._prepared = None
        # the last publication, for observability and cache invalidation:
        # {"mode": "full"|"delta"|"republish", "dirty_clusters",
        #  "dirty_frac", "dirty"}; ``dirty`` is the exact dirty-cluster
        # array wherever the signature was diffed, None with no baseline
        self.last_publish_info: dict | None = None
        self.host_syncs = 0

    @staticmethod
    def shard_init_state(cfg: pipeline.PipelineConfig, seed: int, shard: int,
                         n_data: int, warmup=None,
                         device=None) -> pipeline.PipelineState:
        """The exact state data shard ``shard`` starts from, so that a
        single-device engine can replay its sub-stream."""
        assert 0 <= shard < n_data
        base = pipeline.init(cfg, seed, warmup, device)
        return base._replace(gen=_shard_generator(
            seed, shard, base.route_labels.device))

    def describe(self) -> str:
        return describe(self.mesh)

    @property
    def state(self) -> tuple:
        """The shards' live states (each on its own device)."""
        return tuple(self.shards)

    def _queries(self, q) -> torch.Tensor:
        return host_to_device(q, self.device, torch.float32).contiguous()

    # ---------------------------------------------------------------- ingest
    def ingest(self, x, doc_ids, draws: list | None = None) -> list:
        """Ingest one global microbatch [B, d]: split contiguously into
        ``n_data`` sub-batches, one per data shard. A ragged batch is
        padded with dead rows (``doc_id = -1``), inert in every stage.
        ``draws`` (a test hook) are each shard's heavy-hitter draws.
        Returns the shards' ingest infos."""
        ids = _host_ids(doc_ids)
        x = x if torch.is_tensor(x) else np.asarray(x, np.float32)
        pad = -ids.shape[0] % self.n_data
        if pad:
            ids = np.concatenate([ids, np.full((pad,), -1, np.int32)])
            if torch.is_tensor(x):
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            else:
                x = np.concatenate([x, np.zeros((pad,) + x.shape[1:],
                                                x.dtype)])
        b = ids.shape[0] // self.n_data
        return self.ingest_sharded([x[d * b:(d + 1) * b]
                                    for d in range(self.n_data)],
                                   [ids[d * b:(d + 1) * b]
                                    for d in range(self.n_data)], draws)

    def ingest_sharded(self, xs, idss, draws: list | None = None) -> list:
        """Ingest pre-split sub-batches: ``xs[d]`` [b, d], ``idss[d]`` [b]
        for each data shard d."""
        infos = []
        for d in range(self.n_data):
            self.shards[d], info = ingest_impl(
                self.cfg, self.shards[d], xs[d], idss[d],
                None if draws is None else draws[d])
            self.host_syncs += info["host_syncs"]
            infos.append(info)
        self._ingested += 1
        self._batches_since_reconcile += 1
        if self._batches_since_reconcile >= self.reconcile_every:
            self.reconcile()
        return infos

    # ------------------------------------------------------------- reconcile
    def _host_signature(self):
        """Per-shard (cluster counts, ring write counters, rep ids) [S, k]:
        every snapshot-visible cluster change moves one of them."""
        return tuple(np.stack([f(s).cpu().numpy() for s in self.shards])
                     for f in (lambda s: s.clus.counts,
                               lambda s: s.store.ptr,
                               lambda s: s.rep_ids))

    def prepare_publish(self):
        """The host-blocking part of a delta publish: read the dirty
        signature (which waits for in-flight ingest). The async runtime
        calls this outside its dispatch section, so a flush never waits
        behind it."""
        if self.reconcile_mode == "delta" and self._pub_cache is not None:
            self._prepared = (self._ingested, self._host_signature())

    def _slice(self, store: docstore.DocStore) -> tuple:
        """The full store cut into the model shards' cluster ranges, each
        on its shard's device."""
        return tuple(
            docstore.DocStore(*(t.to(dev) for t in docstore.shard_slice(
                self.cfg.store, store, m, self.n_model)))
            for m, dev in enumerate(self.model_devices))

    def _publish(self, index, route_labels, store) -> ServingSnapshot:
        self._publish_version += 1
        self.serving = ServingSnapshot(index=index, route_labels=route_labels,
                                       store=store,
                                       version=self._publish_version,
                                       published_at=time.time())
        self._batches_since_reconcile = 0
        return self.serving

    def _full(self):
        dev = self.device
        m_clus, m_hh, m_rep, m_store = _merge_shard_states(
            self.cfg, self.shards, dev)
        index, route_labels = stages.upsert_snapshot(
            self.cfg.index, index_lib.init(self.cfg.index, dev), m_hh,
            m_clus.centroids, m_rep)
        self._pub_cache = (m_clus.centroids, m_rep, m_hh.labels.clone())
        return index, route_labels, self._slice(m_store)

    def _delta(self, dirty: np.ndarray):
        """Re-merge the dirty clusters' rows into the previous snapshot;
        the counter merge and the routing table stay full (O(S * bmax))."""
        cfg, dev = self.cfg, self.device
        k = cfg.clus.num_clusters
        kl = k // self.n_model
        idx_d = torch.from_numpy(dirty.astype(np.int64)).to(dev)
        m_clus, m_rep, m_rows = _merge_cluster_rows(cfg, self.shards, dev,
                                                    idx_d)
        m_hh = merge_counters(cfg.hh, [s.hh for s in self.shards], dev)

        pub_cent, pub_rep, slot_labels = self._pub_cache
        new_cent, new_rep = pub_cent.clone(), pub_rep.clone()
        new_cent[idx_d] = m_clus.centroids
        new_rep[idx_d] = m_rep
        cluster_dirty = torch.zeros((k,), dtype=torch.bool, device=dev)
        cluster_dirty[idx_d] = True
        index, route_labels, slot_labels = stages.delta_upsert_snapshot(
            cfg.index, self.serving.index, slot_labels, m_hh, new_cent,
            new_rep, cluster_dirty)
        self._pub_cache = (new_cent, new_rep, slot_labels)
        store = tuple(
            docstore.scatter_rows(prev, m_rows, idx_d - m * kl)
            for m, prev in enumerate(self.serving.store))
        return index, route_labels, store

    def reconcile(self) -> ServingSnapshot:
        """Publish a fresh consistent serving snapshot (see the module
        docstring for the two modes); sets ``last_publish_info``."""
        k = self.cfg.clus.num_clusters
        sig = idx = None
        if self.reconcile_mode == "delta" and self._pub_cache is not None:
            prepared, self._prepared = self._prepared, None
            sig = (prepared[1] if prepared is not None
                   and prepared[0] == self._ingested
                   else self._host_signature())
            dirty = np.zeros((k,), bool)
            for new, old in zip(sig, self._pub_sig):
                dirty |= np.any(new != old, axis=0)
            idx = np.nonzero(dirty)[0].astype(np.int32)
            self._pub_sig = sig
            if idx.size == 0:
                # no shard kept a doc since the last publish: the counters
                # are untouched too, so the snapshot is already exact
                self.last_publish_info = {"mode": "republish",
                                          "dirty_clusters": 0,
                                          "dirty_frac": 0.0, "dirty": idx}
                return self._publish(self.serving.index,
                                     self.serving.route_labels,
                                     self.serving.store)
            if idx.size <= self.delta_max_frac * k:
                self.last_publish_info = {
                    "mode": "delta", "dirty_clusters": int(idx.size),
                    "dirty_frac": float(idx.size) / k, "dirty": idx}
                return self._publish(*self._delta(idx))
        out = self._full()
        if self.reconcile_mode == "delta" and self._pub_sig is None:
            self._pub_sig = self._host_signature()
        # ``dirty`` stays the exact change set where the signature was
        # diffed (a wide delta fell back to the full rebuild); None with no
        # baseline: consumers must assume everything changed
        self.last_publish_info = {"mode": "full", "dirty_clusters": k,
                                  "dirty_frac": 1.0, "dirty": idx}
        return self._publish(*out)

    def publish(self) -> ServingSnapshot:
        """Serving-protocol alias: reconcile and return the snapshot."""
        return self.reconcile()

    # ------------------------------------------------------------ durability
    def checkpoint_state(self):
        """The shards' states stacked on ``mesh[0, 0]`` (``stack_states``):
        the tree the durability layer checkpoints, and the abstract tree
        recovery restores into."""
        return stack_states(self.shards, self.device)

    def restore_state(self, stacked) -> None:
        """Adopt a recovered stacked state, each shard onto its device.
        Every publication baseline drops, so the next publish is a full
        rebuild with ``dirty=None`` (the serving caches clear on it)."""
        self.shards = [unstack_state(stacked, d, dev)
                       for d, dev in enumerate(self.data_devices)]
        self.serving = None
        self._pub_cache = None
        self._pub_sig = None
        self._prepared = None
        self.last_publish_info = None
        self._batches_since_reconcile = 0

    # ----------------------------------------------------------------- query
    def query(self, q, k: int = 10, *, two_stage: bool = False,
              nprobe: int = 8, plan=None):
        """Top-k over the latest snapshot (published first if none)."""
        if self.serving is None:
            self.reconcile()
        return self.query_snapshot(self.serving, q, k, two_stage=two_stage,
                                   nprobe=nprobe, plan=plan)

    def query_snapshot(self, snap: ServingSnapshot, q, k: int = 10, *,
                       two_stage: bool = False, nprobe: int = 8, plan=None,
                       staged: bool = False):
        """Answer from a published snapshot: prototype-only (``mips`` on the
        replicated index), the fused two-stage query (``serve`` once per
        store shard) or, ``staged=True``, ``route`` (``mips``) then
        ``rerank`` once per store shard. ``plan`` overrides (nprobe, rerank
        depth); every shard applies the same ring-prefix clip."""
        q = self._queries(q)
        cfg = self.cfg
        if not two_stage:
            scores, rows, ids = index_lib.search(cfg.index, snap.index, q, k)
            return scores, rows, ids, snap.route_labels[rows.to(torch.int64)]
        nprobe, depth = _resolve_plan(plan, nprobe)
        if not staged:
            return self.routed_query_snapshot(snap, q, k, nprobe, depth)[:4]
        depth_eff = self._check_depth(k, nprobe, depth)
        routes = stages.route(cfg.index, snap.index, snap.route_labels, q,
                              nprobe)
        scores, pos, doc_ids = distributed_rerank_topk(
            l2_normalize_queries(q), snap.store, routes, k, depth_eff)
        return stages.decode_rerank(None, routes, scores, pos, depth_eff,
                                    nprobe, store_depth=cfg.store_depth,
                                    doc_ids=doc_ids)

    def _check_depth(self, k: int, nprobe: int, depth: int | None) -> int:
        store_depth = self.cfg.store_depth
        depth_eff = store_depth if depth is None else min(depth, store_depth)
        assert store_depth > 0, "two_stage requires store_depth > 0"
        assert k <= nprobe * depth_eff, "k must be <= nprobe * plan depth"
        return depth_eff

    def routed_query_snapshot(self, snap: ServingSnapshot, q, k: int,
                              nprobe: int, depth: int | None = None):
        """The fused two-stage query over the sharded store: (scores, rows,
        doc_ids, clusters, routes [Q, nprobe]) — the routes it was served
        through."""
        q = self._queries(q)
        cfg = self.cfg
        depth_eff = self._check_depth(k, nprobe, depth)
        qn = l2_normalize_queries(q)
        qr = qn if cfg.index.normalize else q
        scores, pos, doc_ids, routes = distributed_serve_topk(
            qr, qn, snap.index.vectors, snap.index.valid, snap.route_labels,
            snap.store, k, nprobe, depth)
        return stages.decode_rerank(None, routes, scores, pos, depth_eff,
                                    nprobe, store_depth=cfg.store_depth,
                                    doc_ids=doc_ids) + (routes,)

    # ------------------------------------------------------------ accounting
    def device_counters(self) -> dict:
        """The shards' pipeline counters as one [S, N] host transfer,
        aggregated by ``stages.PIPELINE_COUNTER_COMBINE``; the last
        publication's dirty share rides along."""
        vecs = torch.stack([stages.pipeline_counters(self.cfg, s).to(
            self.device) for s in self.shards])
        out = stages.decode_pipeline_counters(vecs.cpu().numpy())
        if self.last_publish_info is not None:
            out["publish_dirty_clusters"] = \
                self.last_publish_info["dirty_clusters"]
            out["publish_dirty_frac"] = self.last_publish_info["dirty_frac"]
        return out

    def index_size(self) -> int:
        if self.serving is None:
            self.reconcile()
        return int(index_lib.size(self.serving.index))

    def state_memory_bytes(self) -> int:
        return pipeline.state_memory_bytes(self.cfg)

    def store_bytes_per_device(self) -> int:
        """Resident serving-store bytes of one store shard (cluster
        sharding divides the rings over the model axis)."""
        if self.serving is None:
            self.reconcile()
        return sum(t.numel() * t.element_size() for t in self.serving.store[0])
