"""Query-side heavy-hitter hot set + pinned fast-tier serving (Level 1).

Zipf-skewed traffic concentrates on a few query neighborhoods. This
module reuses the paper's counter-based heavy-hitter filter
(``core.heavy_hitter``) on the *query* side: every flushed batch's
route-label signatures (a stable hash of each query's ordered route set)
stream through an ``HHState``, so the counter's top slots name the route
sets hot queries actually touch. On a card every observed flush is one
launch of the ``heavy_hitter`` kernel on the query thread's stream. The
hot signatures' routed clusters are gathered into a compact **pinned
tier** — a contiguous row-subset of the doc store
(``stages.gather_rings``: same dtype, same scales, exact ring copies) —
and hot-neighborhood queries serve through the ``serve`` kernel with the
tier as the ring source and a tier-slot-remapped route-label table.

Bit-identity is by construction, not by tolerance:

  * stage-1 route-slot selection depends only on (query, index vectors,
    index valid) — identical on both paths;
  * ``hot_route_labels = cluster_to_slot[route_labels]`` maps every live
    route of a *covered* query (all routed clusters pinned) to the tier
    slot holding an exact copy of that cluster's ring, and every dead
    route to -1 — so the rerank sees the same vectors, same live mask,
    same scales, in the same order, and emits bit-identical scores/pos
    (the serve kernel's per-query answer depends neither on how many
    queries share its launch nor on how many rings the source holds);
  * decode against the tier's ids gives the same doc ids; tier-slot rows
    and cluster columns are remapped to true store coordinates on the
    host afterwards.

Staleness is exact: the tier is valid for a new snapshot iff no pinned
cluster is in the publish's dirty set (the same (counts, ptr, rep-ids)
change detector delta publication uses). A dirty overlap — or a publish
without dirty info — marks the tier stale and it is rebuilt from the
*current* snapshot at the next flush; a clean publish only refreshes the
route-label remap (the pinned rings are untouched by construction).

The tier shape is fixed at construction: the pin budget is floored to a
power-of-two cluster count, so the pinned bytes charged against the
memory envelope are the resident block, padding included.

The counter's draws come from an explicit ``torch.Generator`` seeded
from ``seed`` (the reference folds its update count into a JAX key).
With MIN_EVICT at ``admit_prob=1`` no draw decides anything, so the
counts, the signatures and the selection equal the reference's.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.core import heavy_hitter
from repro_torch.engine import stages
from repro_torch.engine.engine import routed_query
from repro_torch.kernels.common import host_to_device, resolve_device
from repro_torch.store import docstore


def route_signature(routes_row: np.ndarray) -> int:
    """Stable int32 label (>= 0) for one query's route set; -1 when the
    query routed nowhere (inert for the counter). Signatures hash the
    *sorted* live routes — a collision can only mis-share a counter slot
    (pin selection quality), never affect answer correctness."""
    live = routes_row[routes_row >= 0]
    if live.size == 0:
        return -1
    return zlib.crc32(np.sort(live).astype(np.int32).tobytes()) & 0x7FFFFFFF


def per_cluster_bytes(store_cfg: docstore.StoreConfig) -> int:
    """Resident bytes one pinned cluster row costs — the store's own
    dtype-aware accounting at num_clusters=1."""
    return docstore.memory_bytes(
        dataclasses.replace(store_cfg, num_clusters=1))


class HotSet:
    """Hot-set tracker + pinned tier for one serving runtime.

    All methods run on the runtime's query path except ``note_publish``,
    which the runtime calls while draining its publish-event queue (also
    on the query path) — no internal locking needed. The counter and the
    tier live on ``device`` (``cuda`` unless given).
    """

    def __init__(self, cfg, *, max_batch: int, pin_budget_bytes: int,
                 capacity: int = 32, refresh_every: int = 16,
                 min_count: int = 2, seed: int = 0, device=None):
        self.cfg = cfg
        self.store_cfg = cfg.store
        self.store_depth = cfg.store_depth
        self.max_batch = max_batch
        self.refresh_every = max(1, refresh_every)
        self.min_count = min_count
        self.device = resolve_device(device)
        # query-side heavy hitter: every flushed signature counts
        # (admit_prob=1 — query tracking never subsamples), MIN_EVICT
        # keeps the most frequent route sets
        self.hh_cfg = heavy_hitter.HHConfig(
            capacity=capacity, admit_prob=1.0,
            policy=heavy_hitter.Policy.MIN_EVICT)
        self.hh = heavy_hitter.init(self.hh_cfg, self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._sig_routes: dict[int, tuple[int, ...]] = {}
        # fixed tier shape: pow2 floor of the budget, capped at the
        # cluster count
        per_c = per_cluster_bytes(cfg.store)
        max_pinned = int(pin_budget_bytes // per_c)
        bucket = 1 << max(max_pinned, 1).bit_length() - 1
        self.bucket = min(bucket, cfg.clus.num_clusters) if max_pinned else 0
        self.per_cluster_bytes = per_c
        # tier state (None until the first selection pins something)
        self._clusters: np.ndarray | None = None   # [H] true cluster ids
        self._slot2cluster: np.ndarray | None = None  # [bucket] (-1 pad)
        self._c2s: np.ndarray | None = None        # [k] cluster -> tier slot
        self._tier = None                          # DocStore [bucket, ...]
        self._hot_labels = None                    # [bmax] remapped labels
        self._label_version = -1
        self._stale = False
        self._flushes = 0
        # stats
        self.rebuilds = 0
        self.remaps = 0
        self.stale_marks = 0
        self.served = 0

    # --------------------------------------------------------------- tracking
    def signatures(self, routes: np.ndarray) -> np.ndarray:
        sigs = np.full((routes.shape[0],), -1, np.int32)
        for i in range(routes.shape[0]):
            sig = route_signature(routes[i])
            sigs[i] = sig
            if sig >= 0 and sig not in self._sig_routes:
                self._sig_routes[sig] = tuple(
                    sorted(int(c) for c in routes[i] if c >= 0))
        return sigs

    def observe(self, routes: np.ndarray) -> None:
        """Stream one flushed batch's route signatures through the
        counter (padded to the fixed max_batch shape; -1 rows are
        no-ops, so padding never perturbs the counts): one launch of the
        ``heavy_hitter`` kernel on a card."""
        sigs = self.signatures(np.asarray(routes))
        padded = np.full((self.max_batch,), -1, np.int32)
        padded[:min(sigs.size, self.max_batch)] = sigs[:self.max_batch]
        self.hh, _ = heavy_hitter.update_batch(
            self.hh_cfg, self.hh, host_to_device(padded, self.device),
            gen=self._gen)
        self._flushes += 1

    # ------------------------------------------------------------ invalidation
    def note_publish(self, version: int, dirty) -> None:
        """Apply one publication to the tier: a clean publish only ages
        the route-label remap (rings untouched); a dirty overlap — or no
        dirty info at all — marks the tier stale for rebuild."""
        if self._tier is None:
            return
        if dirty is None:
            self._stale = True
            self.stale_marks += 1
            return
        dirty_set = np.asarray(dirty).ravel()
        if dirty_set.size and np.isin(self._clusters, dirty_set).any():
            self._stale = True
            self.stale_marks += 1

    # ----------------------------------------------------------------- tier
    def _select(self) -> np.ndarray:
        """Greedy hot-cluster selection: walk counter slots by estimated
        count, union their route sets until the pinned bucket is full."""
        counts = heavy_hitter.estimated_counts(self.hh_cfg,
                                               self.hh).cpu().numpy()
        mask = heavy_hitter.active_mask(self.hh).cpu().numpy()
        labels = self.hh.labels.cpu().numpy()
        live = {int(s) for s in labels[labels >= 0]}
        self._sig_routes = {s: r for s, r in self._sig_routes.items()
                            if s in live}
        selected: list[int] = []
        seen: set[int] = set()
        for slot in np.argsort(-counts):
            if not mask[slot] or counts[slot] < self.min_count:
                continue
            for c in self._sig_routes.get(int(labels[slot]), ()):
                if c not in seen and len(selected) < self.bucket:
                    seen.add(c)
                    selected.append(c)
            if len(selected) >= self.bucket:
                break
        return np.asarray(sorted(selected), np.int32)

    def _build(self, snap, clusters: np.ndarray) -> None:
        k = self.cfg.clus.num_clusters
        h = clusters.size
        idx = np.zeros((self.bucket,), np.int32)
        idx[:h] = clusters
        valid = np.zeros((self.bucket,), bool)
        valid[:h] = True
        self._tier = stages.gather_rings(
            snap.store, host_to_device(idx, self.device),
            host_to_device(valid, self.device))
        self._clusters = clusters
        self._slot2cluster = np.full((self.bucket,), -1, np.int32)
        self._slot2cluster[:h] = clusters
        self._c2s = np.full((k,), -1, np.int32)
        self._c2s[clusters] = np.arange(h, dtype=np.int32)
        self._stale = False
        self.rebuilds += 1
        self._remap_labels(snap)

    def _remap_labels(self, snap) -> None:
        labels = snap.route_labels.cpu().numpy()
        hot = np.where(labels >= 0, self._c2s[np.maximum(labels, 0)], -1)
        self._hot_labels = host_to_device(hot.astype(np.int32), self.device)
        self._label_version = snap.version
        self.remaps += 1

    def sync(self, snap) -> None:
        """Bring the tier up to date for the snapshot this flush pinned:
        reselect/rebuild on the refresh cadence or when stale, else just
        refresh the route-label remap when the snapshot moved. Runs on
        the query stream, after it waited for the snapshot's publish."""
        if self.bucket == 0:
            return
        due = self._flushes >= self.refresh_every
        if due or (self._stale and self._tier is not None):
            if due:
                self._flushes = 0
            clusters = self._select()
            if clusters.size and (self._stale or self._clusters is None
                                  or not np.array_equal(clusters,
                                                        self._clusters)):
                self._build(snap, clusters)
            elif self._stale and not clusters.size:
                self._tier = None       # nothing hot enough to re-pin
                self._clusters = None
                self._stale = False
        if self._tier is not None and self._label_version != snap.version:
            self._remap_labels(snap)

    @property
    def active(self) -> bool:
        return self._tier is not None and not self._stale

    def covered(self, routes: np.ndarray) -> np.ndarray:
        """[B] bool — every live route of the query is pinned (its whole
        rerank input lives in the tier)."""
        if not self.active:
            return np.zeros((routes.shape[0],), bool)
        ok = self._c2s[np.maximum(routes, 0)] >= 0
        return np.all(ok | (routes < 0), axis=1)

    def serve(self, snap, q: torch.Tensor, k: int, nprobe: int, depth: int):
        """The ``serve`` kernel over the pinned tier: (scores, rows,
        doc_ids, clusters, routes) as device tensors in tier coordinates —
        remap with ``remap``/``remap_routes``."""
        assert self.active and self._label_version == snap.version
        self.served += q.shape[0]
        return routed_query(self.cfg, snap.index, self._hot_labels,
                            self._tier, q, k, nprobe, depth)

    def remap(self, rows_t: np.ndarray, clusters_t: np.ndarray):
        """Tier-slot (rows, clusters) -> true store coordinates."""
        live = clusters_t >= 0
        slot = np.where(live, rows_t % self.store_depth, 0)
        true_c = np.where(
            live, self._slot2cluster[np.clip(clusters_t, 0, None)], -1)
        rows = np.where(live, true_c * self.store_depth + slot, -1)
        return rows.astype(np.int32), true_c.astype(np.int32)

    def remap_routes(self, routes_t: np.ndarray) -> np.ndarray:
        """Tier-slot routes -> true cluster ids (-1 stays -1)."""
        return np.where(routes_t >= 0,
                        self._slot2cluster[np.clip(routes_t, 0, None)],
                        -1).astype(np.int32)

    # ------------------------------------------------------------------ stats
    @property
    def pinned_bytes(self) -> int:
        return self.bucket * self.per_cluster_bytes if self._tier is not None \
            else 0

    def stats(self) -> dict:
        return {
            "pinned_clusters": int(self._clusters.size)
            if self._clusters is not None else 0,
            "tier_bucket": self.bucket,
            "pinned_bytes": self.pinned_bytes,
            "rebuilds": self.rebuilds,
            "remaps": self.remaps,
            "stale_marks": self.stale_marks,
            "hot_served": self.served,
            "tracked_signatures": len(self._sig_routes),
        }
