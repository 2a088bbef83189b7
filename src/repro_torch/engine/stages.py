"""The composable stages of the streaming engine.

Each stage is a function over plain state tuples; ``engine.engine``
composes them into the single-device step.

Stage map (ingest):

    admit (fused screen + assign + quantize-on-admit: the ``admit`` kernel)
      │        ──► count ──► update_representatives
      │                        ├──► store_write     (rows pre-quantized
      │                        │                     by admit)
      │                        └──► upsert_snapshot (every T arrivals)
      └── staged: screen (the ``prefilter`` kernel) ──► assign_update (the
          ``assign`` kernel), then store_write quantizes store-side —
          the same keep/labels/rows/scales as ``admit``

Stage map (two-stage query):

    serve_topk (fused route + gather + dequant-rerank + top-k: the
      │         ``serve`` kernel) ──► decode_rerank
      └── staged: route (prototype index: the ``mips`` kernel) ──► rerank
          (ring buffers: the ``rerank`` kernel) — the same routes/pos as
          ``serve_topk``

The staged forms are the decomposition the fused kernels are held
against; an engine composes the fused ones. ``route_witnessed`` is
``serve_topk``'s stage 1 alone (the ``serve`` kernel's route-only
entry), the serving cache's route witness. ``gather_rings`` pins the
hot-set serving tier (``serve.hotset``); ``delta_upsert_snapshot`` is
the sharded engine's delta publish (``engine.sharded``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import clustering, heavy_hitter, index as index_lib, prefilter
from repro_torch.kernels.admit.ops import admit as admit_op
from repro_torch.kernels.common import (NEG_INF, host_to_device, l2_normalize,
                                        l2_normalize_queries)
from repro_torch.kernels.rerank.ops import rerank_topk
from repro_torch.kernels.serve.ops import serve_routes as serve_routes_op
from repro_torch.kernels.serve.ops import serve_topk as serve_topk_op
from repro_torch.store import docstore

INT32_MIN = -(2**31)


# --------------------------------------------------------------------- ingest
def _live_on(live: np.ndarray | None, device) -> torch.Tensor | None:
    return None if live is None else host_to_device(np.asarray(live, bool),
                                                    device)


def screen(pre_cfg: prefilter.PrefilterConfig, pre_state, x: torch.Tensor,
           live: np.ndarray | None = None):
    """(1) adaptive-basis window ingest + (2) relevance screening, the
    staged form of ``admit``'s decision. ``live`` is the host's [B] bool
    mask of real rows: dead rows stay out of the window and are never
    kept. Returns (pre, r, keep)."""
    pre = prefilter.ingest(pre_cfg, pre_state, x, mask=live)
    r, keep = prefilter.score(pre_cfg, pre, x)
    live_t = _live_on(live, x.device)
    if live_t is not None:
        keep = keep & live_t
    return pre, r, keep


def assign_update(clus_cfg: clustering.ClusterConfig, clus_state,
                  x: torch.Tensor, keep: torch.Tensor):
    """(3) cluster assignment + centroid update over the kept rows, the
    staged form of ``admit``'s labels. Returns (clus, labels, sims)."""
    labels, sims = clustering.assign(clus_cfg, clus_state, x)
    clus = clustering.update(clus_cfg, clus_state, x, labels, keep)
    return clus, labels, sims


def admit(pre_cfg: prefilter.PrefilterConfig,
          clus_cfg: clustering.ClusterConfig,
          store_cfg: docstore.StoreConfig,
          pre_state, clus_state, x: torch.Tensor,
          live: np.ndarray | None = None):
    """(1)+(2)+(3) fused: window ingest, then the ``admit`` kernel (score,
    keep = threshold & live, label + cosine, the ring-write-ready row),
    then the centroid update. ``live`` is the host's [B] bool mask of real
    rows. Returns (pre, r, keep, clus, labels, sims, v, vscale); v/vscale
    are None when the store is disabled."""
    pre = prefilter.ingest(pre_cfg, pre_state, x, mask=live)
    live_t = _live_on(live, x.device)
    r, keep, labels, sims, v, vscale = admit_op(
        x, pre.basis, clus_state.centroids, pre_cfg.alpha, live_t,
        store_dtype=store_cfg.store_dtype, normalize=store_cfg.normalize,
        emit_rows=store_cfg.depth > 0)
    clus = clustering.update(clus_cfg, clus_state, x, labels, keep)
    return pre, r, keep, clus, labels, sims, v, vscale


def count(hh_cfg: heavy_hitter.HHConfig, hh_state, labels: torch.Tensor,
          keep: torch.Tensor, draws: dict | None = None,
          gen: torch.Generator | None = None):
    """(4) heavy-hitter counting over retained labels (the ``heavy_hitter``
    kernel: the per-arrival update, in order, as one launch)."""
    masked = torch.where(keep, labels, -1).to(torch.int32)
    hh, info = heavy_hitter.update_batch(hh_cfg, hh_state, masked, gen=gen,
                                         draws=draws)
    return hh, masked, info


def update_representatives(rep_ids, rep_sims, labels, sims, doc_ids, keep,
                           k: int):
    """Track the freshest member doc per cluster (recency scatter-max):
    doc ids are monotone in arrival time, so the max id is the newest."""
    seg = torch.where(keep, labels, k).to(torch.int64)
    cand = torch.where(keep, doc_ids, -1).to(torch.int32)
    newest = torch.full((k + 1,), INT32_MIN, dtype=torch.int32,
                        device=rep_ids.device).scatter_reduce(
        0, seg, cand, reduce="amax")[:k]
    new_ids = torch.maximum(rep_ids, newest)
    lc = torch.clamp(labels, max=k - 1).to(torch.int64)
    wins = keep & (doc_ids >= new_ids[lc])
    # scatter into a padded copy: row k takes the non-winners (dropped)
    padded = torch.cat([rep_sims, rep_sims.new_zeros(1)])
    padded[torch.where(wins, labels, k).to(torch.int64)] = \
        torch.where(wins, sims, 0.0)
    return new_ids, padded[:k]


def store_write(store_cfg: docstore.StoreConfig, store, x, labels, stored,
                doc_ids, stamps, v=None, vscale=None):
    """Ring-write docs that passed both filters (pre-filter relevance and a
    counter-tracked cluster at arrival); v/vscale are admit's rows."""
    return docstore.add_batch(store_cfg, store, x, labels, stored, doc_ids,
                              stamps, v=v, vscale=vscale)


def upsert_snapshot(index_cfg: index_lib.IndexConfig, index, hh_state,
                    centroids, rep_ids):
    """(5) rebuild the prototype index from the live counter slots and
    snapshot the slot -> label routing table at the same instant.
    Returns (new_index, route_labels [bmax] i32, -1 for dead slots)."""
    lbl = hh_state.labels
    bmax = lbl.shape[0]
    lc = torch.clamp(lbl, min=0).to(torch.int64)
    valid = heavy_hitter.active_mask(hh_state)
    new_index = index_lib.upsert(
        index_cfg, index, torch.arange(bmax, device=lbl.device),
        centroids[lc], rep_ids[lc], valid)
    return new_index, torch.where(valid, lbl, -1)


def delta_upsert_snapshot(index_cfg: index_lib.IndexConfig, prev_index,
                          prev_slot_labels, hh_state, centroids, rep_ids,
                          cluster_dirty):
    """Delta form of ``upsert_snapshot``: re-write only the slots whose
    row can have changed since the previous publish — its raw counter
    label changed (``prev_slot_labels`` is the raw ``hh.labels`` of that
    publish), its validity flipped, or its cluster is dirty (centroid or
    representative moved) — and keep every other row of ``prev_index``.
    Those rows are what a full rebuild would write, so a delta publish
    equals a full one bit for bit. ``prev_index`` is not written.

    Returns (new_index, route_labels, slot_labels): ``slot_labels`` is
    the raw label snapshot the next delta publish compares against."""
    lbl = hh_state.labels
    valid = heavy_hitter.active_mask(hh_state)
    lc = torch.clamp(lbl, min=0).to(torch.int64)
    stale = ((lbl != prev_slot_labels) | (valid != prev_index.valid)
             | cluster_dirty[lc])
    vecs = (l2_normalize(centroids[lc]) if index_cfg.normalize
            else centroids[lc].to(torch.float32))
    new_index = index_lib.FlatIndex(
        vectors=torch.where(stale[:, None], vecs, prev_index.vectors),
        ids=torch.where(stale, torch.where(valid, rep_ids[lc], -1),
                        prev_index.ids).to(torch.int32),
        valid=valid.clone(),
        version=prev_index.version)   # full rebuilds always publish 1
    return new_index, torch.where(valid, lbl, -1), lbl.clone()


# -------------------------------------------------------------- observability
PIPELINE_COUNTER_NAMES = (
    "arrivals", "admitted", "hh_seen", "hh_evictions", "hh_writes",
    "hh_occupied", "hh_capacity", "hh_max_count", "store_live",
    "store_slots", "store_min_fill", "store_max_fill", "index_valid",
    "upserts",
)
# how the shards' counter vectors aggregate (aligned with the names):
# extensive quantities sum across data shards, extrema take min/max, the
# shard-local index reports the shard max
PIPELINE_COUNTER_COMBINE = (
    "sum", "sum", "sum", "sum", "sum", "sum", "sum", "max", "sum", "sum",
    "min", "max", "max", "sum",
)
assert len(PIPELINE_COUNTER_NAMES) == len(PIPELINE_COUNTER_COMBINE)


def pipeline_counters(cfg, state) -> torch.Tensor:
    """Reduce a ``PipelineState`` to the ``[len(PIPELINE_COUNTER_NAMES)]``
    i32 counter vector on the state's device."""
    hh = state.hh
    dev = hh.labels.device
    occ = heavy_hitter.active_mask(hh)
    k, depth = state.store.ids.shape
    z = torch.zeros((), dtype=torch.int32, device=dev)
    if depth > 0:
        fill = torch.sum((state.store.ids >= 0).to(torch.int32), dim=1)
        store = (fill.sum(), fill.min(), fill.max())
    else:
        store = (z, z, z)

    def host(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    vals = [host(state.arrivals), state.kept, hh.total_seen,
            hh.total_evictions, hh.total_writes,
            occ.to(torch.int32).sum(), hh.active_capacity,
            torch.where(occ, hh.counts, 0).max(), store[0], host(k * depth),
            store[1], store[2], state.index.valid.to(torch.int32).sum(),
            host(state.upserts)]
    return torch.stack([v.to(torch.int32).reshape(()) for v in vals])


def decode_pipeline_counters(stacked) -> dict:
    """Host decode of fetched counter vectors ``[S, N]`` (S = 1 for the
    single-device engine), aggregated across shards by
    ``PIPELINE_COUNTER_COMBINE``, plus the derived rates."""
    arr = np.asarray(stacked, dtype=np.int64)
    assert arr.ndim == 2 and arr.shape[1] == len(PIPELINE_COUNTER_NAMES), \
        arr.shape
    reduce = {"sum": np.sum, "max": np.max, "min": np.min}
    out = {name: int(reduce[comb](arr[:, i])) for i, (name, comb) in
           enumerate(zip(PIPELINE_COUNTER_NAMES, PIPELINE_COUNTER_COMBINE))}
    out["admit_rate"] = out["admitted"] / max(out["arrivals"], 1)
    out["store_fill"] = out["store_live"] / max(out["store_slots"], 1)
    out["hh_occupancy"] = out["hh_occupied"] / max(out["hh_capacity"], 1)
    return out


# ---------------------------------------------------------------------- query
def route(index_cfg: index_lib.IndexConfig, index, route_labels,
          q: torch.Tensor, nprobe: int) -> torch.Tensor:
    """Stage 1: the prototype index routes each query to its top-``nprobe``
    clusters. Returns routes [Q, nprobe] i32 cluster ids (-1 = no route)."""
    sc1, slots, _ = index_lib.search(index_cfg, index, q, nprobe)
    return _route_ids(sc1, slots, route_labels)


def _route_ids(sc1, slots, route_labels) -> torch.Tensor:
    labels = route_labels[slots.to(torch.int64)]
    return torch.where((sc1 > NEG_INF / 2) & (labels >= 0), labels,
                       -1).to(torch.int32)


def route_witnessed(index_cfg: index_lib.IndexConfig, index, route_labels,
                    q: torch.Tensor, nprobe: int) -> np.ndarray:
    """Stage 1 as the serving cache's witness: routes [Q, nprobe] i32 on
    the host, from the ``serve`` kernel's route-only entry. They are the
    routes ``serve_topk`` serves ``q`` through, bit for bit and in its
    order, near-ties included (one computation: the fused kernel's route
    tiles and selection). On the CPU both run ``serve_routes_ref``, which
    is ``route``'s plain mips pass."""
    qr = (l2_normalize_queries(q) if index_cfg.normalize
          else q.to(torch.float32).contiguous())
    return serve_routes_op(qr, index.vectors, index.valid, route_labels,
                           nprobe).cpu().numpy()


def slice_rings(embs, live, scales, depth: int | None):
    """Clip ring buffers to a plan's rerank ``depth`` as views (the serve
    kernel reads them through their strides; nothing is copied). None or
    ``depth >= store depth`` passes the arrays through."""
    if depth is None or depth >= embs.shape[1]:
        return embs, live, scales
    return (embs[:, :depth], live[:, :depth],
            None if scales is None else scales[:, :depth])


def rerank(store, qn: torch.Tensor, routes: torch.Tensor, k: int,
           depth: int | None = None):
    """Stage 2: exact rerank of the routed ring buffers (first ``depth``
    slots; None = full) of unit queries ``qn``; int8 stores hand the
    kernel their per-slot scales. Returns (scores [Q, k] desc, pos [Q, k]
    = j*depth+slot into the route list, -1 for dead entries)."""
    scales = store.scales if store.embs.dtype == torch.int8 else None
    embs, live, scales = slice_rings(store.embs, docstore.live_mask(store),
                                     scales, depth)
    return rerank_topk(qn, embs, live, routes, k, scales=scales)


def serve_topk(index_cfg: index_lib.IndexConfig, index, route_labels, store,
               q: torch.Tensor, k: int, nprobe: int, depth: int | None = None):
    """Stages 1+2 fused in the ``serve`` kernel: route each query through
    the prototype index to ``nprobe`` clusters, gather their rings (first
    ``depth`` slots; None = full), dequant-rerank, top-``k``. Returns
    (scores [Q, k] desc, pos [Q, k] = j*depth+slot, routes [Q, nprobe]),
    -1 for dead entries."""
    qn = l2_normalize_queries(q)
    qr = qn if index_cfg.normalize else q.to(torch.float32).contiguous()
    scales = store.scales if store.embs.dtype == torch.int8 else None
    embs, live, scales = slice_rings(store.embs, docstore.live_mask(store),
                                     scales, depth)
    return serve_topk_op(qr, qn, index.vectors, index.valid, route_labels,
                         embs, live, k, nprobe, scales=scales)


def gather_rings(store, clusters: torch.Tensor, valid: torch.Tensor):
    """Gather a row-subset of a doc store into a compact contiguous block —
    the hot-set serving tier's pin step.

    ``clusters`` [H] i32/i64 store rows to pin (padding rows may repeat a
    real cluster); ``valid`` [H] bool marks real entries. ``store`` may
    be cluster-sharded (a tuple of shards, ``docstore.gather_rows``). The gathered
    rows are exact copies of the source rings (same dtype, same scales,
    same stamps), so a rerank over the tier is bit-identical to one over
    the full store; padded rows get all-dead ids (-1), so ``live_mask``
    kills them and they can never surface a document.

    Returns a ``DocStore`` of shape ``[H, depth, ...]`` addressed by tier
    slot — callers route into it with a remapped ``route_labels`` (true
    cluster id -> tier slot, -1 for unpinned)."""
    tier = docstore.gather_rows(store, clusters)
    return tier._replace(ids=torch.where(valid[:, None], tier.ids, -1))


def decode_rerank(store_ids, routes, scores, pos, depth: int, nprobe: int,
                  store_depth: int | None = None, doc_ids=None):
    """Resolve rerank positions into (scores, rows, doc_ids, clusters);
    rows are flat store positions cluster*store_depth + slot, -1 where
    dead. ``depth`` is the depth ``pos`` was encoded with. ``doc_ids``
    may come resolved (the sharded rerank reads them on the shard that
    holds the ring); otherwise they are read from ``store_ids``."""
    if store_depth is None:
        store_depth = depth
    dead = pos < 0
    p = pos.to(torch.int64)
    j = torch.clamp(torch.div(p, depth, rounding_mode="floor"), 0, nprobe - 1)
    slot = torch.clamp(torch.remainder(p, depth), 0, depth - 1)
    cluster = torch.gather(routes.to(torch.int64), 1, j)
    cluster = torch.where(dead, -1, cluster)
    cc = torch.clamp(cluster, min=0)
    if doc_ids is None:
        doc_ids = torch.where(dead, -1, store_ids[cc, slot])
    rows = torch.where(dead, -1, cc * store_depth + slot)
    return (scores, rows.to(torch.int32), doc_ids.to(torch.int32),
            cluster.to(torch.int32))
