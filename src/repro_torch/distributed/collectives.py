"""Collectives of the sharded streaming engine, over per-shard lists.

The reference runs these inside ``shard_map`` over a mesh axis; here one
process holds every shard's tensors, each on its shard's device, and a
collective is an explicit function of the list: an all-gather is a
``.to(device)`` of each shard's part, concatenated in shard order; a
``pmax`` an elementwise max in shard order; a psum a fold from shard 0
upward. The merge order is the reference's, so a sharded answer equals
the single-device one. While an ``analysis.hlo_cost`` counter is active,
``fold_sum``, ``all_gather`` and ``hierarchical_psum`` record their
result bytes by collective type (the distributed top-k and rerank through
their all-gathers).

  * ``fold_sum`` / ``all_gather`` / ``hierarchical_psum`` — psum, the
    all-gather and the reduce-scatter / inter-pod sum / all-gather of the
    reference's explicit hierarchical all-reduce;
  * ``merge_clusters`` / ``merge_counters`` — the count-weighted centroid
    merge and the label-union counter merge (``heavy_hitter.merge``
    folded from shard 0 upward);
  * ``distributed_mips_topk`` — index rows sharded, local top-k, global
    merge;
  * ``distributed_rerank_topk`` / ``distributed_serve_topk`` — the doc
    store cluster-sharded: each shard reranks (``rerank``) or routes and
    reranks (``serve``) its own rings under localized routes or labels,
    then ``_merge_local_rerank`` merges with the single-device
    tie-break.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.hlo_cost import collective
from repro_torch.core import clustering, heavy_hitter
from repro_torch.kernels.common import NEG_INF, stable_topk


@collective("all-reduce")
def fold_sum(parts: list[torch.Tensor], device) -> torch.Tensor:
    """``psum``: the parts summed from shard 0 upward, on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


@collective("all-gather")
def all_gather(parts: list[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The shards' parts concatenated in shard order along ``dim``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


@collective("all-reduce")
def hierarchical_psum(parts, device, pod_axis: str | None = "pod") -> torch.Tensor:
    """Explicit hierarchical all-reduce over a ``[pod][data]`` grid of
    parts: reduce-scatter along dim 0 within each pod (data shard j sums
    the pod's j-th slices), sum over the pods on the scattered slices, then
    all-gather within the pod. With ``pod_axis=None`` ``parts`` is one flat
    list over the data shards and this is ``fold_sum``. Every shard ends
    with the same total; it is returned once, on ``device``."""
    if pod_axis is None:
        return fold_sum(parts, device)
    n_data = len(parts[0])
    rows = parts[0][0].shape[0]
    if rows % n_data or any(len(pod) != n_data for pod in parts):
        raise ValueError(f"dim 0 of size {rows} does not scatter over "
                         f"{n_data} data shards in every pod")
    scattered = [[fold_sum([x.chunk(n_data, dim=0)[j] for x in pod], device)
                  for j in range(n_data)] for pod in parts]
    return all_gather([fold_sum([pod[j] for pod in scattered], device)
                       for j in range(n_data)], device)


def merge_clusters(states: list[clustering.ClusterState],
                   device) -> clustering.ClusterState:
    """Count-weighted centroid merge; clusters no shard saw keep shard
    0's centroid (every shard starts from one shared init)."""
    n = fold_sum([s.counts for s in states], device)
    wsum = fold_sum([s.centroids * s.counts[:, None] for s in states], device)
    c = torch.where((n > 0)[:, None], wsum / torch.clamp(n, min=1.0)[:, None],
                    states[0].centroids.to(device))
    return clustering.ClusterState(centroids=c, counts=n)


def merge_counters(cfg: heavy_hitter.HHConfig,
                   states: list[heavy_hitter.HHState],
                   device) -> heavy_hitter.HHState:
    """Fold pairwise label-union merges from shard 0 upward."""
    merged = heavy_hitter.HHState(*(t.to(device) for t in states[0]))
    for s in states[1:]:
        merged = heavy_hitter.merge(cfg, merged, s)
    return merged


def distributed_mips_topk(q: torch.Tensor, index_rows: list[torch.Tensor],
                          valid: list[torch.Tensor], k: int):
    """Index rows sharded over shards (equal row counts); ``q`` [Q, d]
    replicated. Each shard's exact local top-k, then the merged top-k
    with ties to the lowest global row. Returns (scores [Q, k], global
    rows [Q, k]) on ``q``'s device."""
    from repro_torch.kernels.mips.ops import mips_topk

    dev = q.device
    sc, ids = [], []
    for m, (rows, ok) in enumerate(zip(index_rows, valid)):
        n_local = rows.shape[0]
        s, r = mips_topk(q.to(rows.device), rows, ok, min(k, n_local))
        sc.append(s)
        ids.append(r.to(torch.int64) + m * n_local)
    all_sc, all_id = all_gather(sc, dev, 1), all_gather(ids, dev, 1)
    top, pos = stable_topk(all_sc, k)
    return top, torch.gather(all_id, 1, pos).to(torch.int32)


def localize(labels: torch.Tensor, off: int, kl: int) -> torch.Tensor:
    """Global cluster ids -> this store shard's rows ``[off, off+kl)``;
    -1 for a cluster on another shard (and for -1)."""
    return torch.where((labels >= off) & (labels < off + kl), labels - off,
                       -1).to(torch.int32)


def _ring_inputs(store, depth: int | None):
    """(embs, ids, scales) of one store shard, clipped to a plan's rerank
    ``depth`` as views (a slot is live where its id is >= 0)."""
    from repro_torch.engine.stages import slice_rings

    scales = store.scales if store.embs.dtype == torch.int8 else None
    return slice_rings(store.embs, store.ids, scales, depth)


def distributed_rerank_topk(qn: torch.Tensor, stores: list, routes: torch.Tensor,
                            k: int, depth: int | None = None):
    """The staged stage 2 over a cluster-sharded store: ``stores`` are the
    shards' DocStores in shard order (shard m holds global clusters
    ``[m*kl, (m+1)*kl)``); ``qn`` [Q, d] unit queries and ``routes`` [Q,
    P] global cluster ids, replicated. Each shard masks the routes to
    its own clusters (keeping the global route positions), reranks its
    rings (the ``rerank`` kernel), and the per-shard top-k merge. Returns
    (scores [Q, k] desc, pos [Q, k] = j*depth+slot, doc_ids [Q, k]) on
    ``qn``'s device; -1 where dead."""
    from repro_torch.kernels.rerank.ops import rerank_topk

    P = routes.shape[1]
    parts = []
    for m, store in enumerate(stores):
        embs, ids, scales = _ring_inputs(store, depth)
        kl, dep = embs.shape[0], embs.shape[1]
        local = localize(routes.to(embs.device), m * kl, kl)
        scores, pos = rerank_topk(qn.to(embs.device), embs, ids, local, k,
                                  scales=scales)
        parts.append(_local_docs(scores, pos, local, ids, P, dep))
    return _merge_local_rerank(parts, k, qn.device)


def _local_docs(scores, pos, local_routes, ids, P: int, depth: int):
    """Resolve one shard's candidates to doc ids while its rings are at
    hand; (scores, position key with dead entries at P*depth, doc ids)."""
    dead = pos < 0
    p = pos.to(torch.int64)
    j = torch.clamp(torch.div(p, depth, rounding_mode="floor"), 0, P - 1)
    slot = torch.clamp(torch.remainder(p, depth), 0, depth - 1)
    lcl = torch.gather(local_routes.to(torch.int64), 1, j)
    doc = torch.where(dead, -1, ids[torch.clamp(lcl, min=0), slot])
    return scores, torch.where(dead, P * depth, p), doc


def _merge_local_rerank(parts, k: int, device):
    """The shards' top-k, gathered in shard order and merged as
    single-device ``lax.top_k`` over the flat [Q, P*depth] table would
    pick: a stable sort by position key (dead last), then a stable sort
    by descending score. Returns (scores, pos, doc ids), -1 where dead."""
    all_sc = all_gather([s for s, _, _ in parts], device, 1)
    all_pos = all_gather([p for _, p, _ in parts], device, 1)
    all_doc = all_gather([d for _, _, d in parts], device, 1)
    o2 = torch.argsort(all_pos, dim=1, stable=True)
    sc2 = torch.gather(all_sc, 1, o2)
    pos2 = torch.gather(all_pos, 1, o2)
    doc2 = torch.gather(all_doc, 1, o2)
    sc, o1 = stable_topk(sc2, k)
    posk = torch.gather(pos2, 1, o1)
    dock = torch.gather(doc2, 1, o1)
    alive = sc > NEG_INF / 2
    return (sc, torch.where(alive, posk, -1).to(torch.int32),
            torch.where(alive, dock, -1).to(torch.int32))


def distributed_serve_topk(qr: torch.Tensor, qn: torch.Tensor, vectors: torch.Tensor,
                           valid: torch.Tensor, route_labels: torch.Tensor,
                           stores: list, k: int, nprobe: int,
                           depth: int | None = None):
    """The fused two-stage query over a cluster-sharded store: every
    shard runs the ``serve`` kernel (route + gather + dequant-rerank +
    top-k) over its own rings, under the label table localized *before*
    the kernel: a valid slot whose cluster lies on another shard carries
    label -1, which the kernel keeps as a dead route position. The index
    is replicated, so every shard picks the same top-``nprobe`` slots in
    the same order, and each position is live on exactly the shard that
    owns its cluster: an elementwise max over the shards' global routes
    (``pmax``) recovers the route list. The candidates merge as in
    ``distributed_rerank_topk``.

    qr/qn [Q, d] stage-1/stage-2 queries; vectors/valid/route_labels the
    replicated prototype index and slot -> global cluster table. Returns
    (scores [Q, k] desc, pos [Q, k], doc_ids [Q, k], routes [Q, nprobe]
    global cluster ids) on ``qn``'s device; -1 where dead."""
    from repro_torch.kernels.serve.ops import serve_topk

    dev = qn.device
    parts, routes = [], None
    for m, store in enumerate(stores):
        embs, ids, scales = _ring_inputs(store, depth)
        kl, dep = embs.shape[0], embs.shape[1]
        sd = embs.device
        labels = localize(route_labels.to(sd), m * kl, kl)
        scores, pos, local_rt = serve_topk(
            qr.to(sd), qn.to(sd), vectors.to(sd), valid.to(sd), labels, embs,
            ids, k, nprobe, scales=scales)[:3]
        glob = torch.where(local_rt >= 0, local_rt + m * kl, -1).to(dev)
        routes = glob if routes is None else torch.maximum(routes, glob)
        parts.append(_local_docs(scores, pos, local_rt, ids, nprobe, dep))
    sc, pos, doc = _merge_local_rerank(parts, k, dev)
    return sc, pos, doc, routes.to(torch.int32)
