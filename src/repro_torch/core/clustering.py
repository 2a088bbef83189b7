"""Streaming mini-batch k-means (paper §Clustering & Label Assignment).

Updates follow the paper's per-assignment rate η = 1/(n_j + 1):
``sequential`` is the per-item rule, ``batched`` (the default) folds each
cluster's batch sum in with its count (sklearn MiniBatchKMeans). ``assign``
is the staged assignment (the ``assign`` kernel); the fused ingest path
takes its labels from the ``admit`` kernel.

The batched fold's per-cluster sums are a one-hot ``[k, B] @ [B, d]``
product in full fp32 rather than ``index_add_``, whose atomics on the
card would make two runs differ in the last bits.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels.assign.ops import assign as assign_op
from repro_torch.kernels.common import l2_normalize


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    num_clusters: int = 100      # k (paper Table 2; §Hyperparams uses 150)
    dim: int = 384
    update_mode: str = "batched"  # "batched" | "sequential" | "frozen"


class ClusterState(NamedTuple):
    centroids: torch.Tensor  # [k, d] f32
    counts: torch.Tensor     # [k] f32 — n_j, prior assignments


def init(cfg: ClusterConfig, gen: torch.Generator) -> ClusterState:
    c = torch.randn((cfg.num_clusters, cfg.dim), generator=gen,
                    device=gen.device)
    return ClusterState(
        centroids=l2_normalize(c),
        counts=torch.zeros((cfg.num_clusters,), dtype=torch.float32,
                           device=gen.device))


def kmeans_plus_plus(gen: torch.Generator, data: torch.Tensor,
                     k: int, picks: torch.Tensor | None = None) -> torch.Tensor:
    """k-means++ seeding over a warmup buffer (D² sampling under cosine
    geometry, distance ``1 - cos``), [k, d]: the picked rows of the unit
    buffer. Once every distinct row has been drawn all distances are 0
    (``torch.multinomial`` refuses an all-zero row), and the draw falls
    back to uniform. ``picks`` [k] (row indices, the first uniform, the
    rest D²-sampled) may be given instead of being drawn from ``gen``."""
    n = data.shape[0]
    xn = l2_normalize(data)
    if picks is not None:
        return xn.index_select(0, torch.as_tensor(picks, dtype=torch.int64,
                                                  device=data.device))
    first = torch.randint(0, n, (1,), generator=gen, device=data.device)
    picks = [xn.index_select(0, first)]
    d2 = 1.0 - xn @ picks[0][0]
    for _ in range(k - 1):
        p = torch.clamp(d2, min=0.0)
        p = torch.where(p.sum() > 0, p, torch.ones_like(p))
        idx = torch.multinomial(p, 1, generator=gen)
        c = xn.index_select(0, idx)
        picks.append(c)
        d2 = torch.minimum(d2, 1.0 - xn @ c[0])
    return torch.cat(picks, dim=0)


def init_from_buffer(cfg: ClusterConfig, gen: torch.Generator,
                     buffer: torch.Tensor) -> ClusterState:
    c = kmeans_plus_plus(gen, buffer, cfg.num_clusters)
    return ClusterState(
        centroids=c,
        counts=torch.zeros((cfg.num_clusters,), dtype=torch.float32,
                           device=buffer.device))


def assign(cfg: ClusterConfig, state: ClusterState, x: torch.Tensor):
    """Nearest centroid (cosine): (labels [B] i32, sims [B] f32)."""
    return assign_op(x, state.centroids)


def _segment_sums(k: int, x: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor):
    """(sums [k, d], cnts [k]) over the masked rows, deterministically."""
    seg = torch.where(mask, labels.to(torch.int64), k)
    onehot = (torch.arange(k, device=x.device)[:, None]
              == seg[None, :]).to(torch.float32)              # [k, B]
    sums = onehot @ x.to(torch.float32)
    return sums, onehot.sum(dim=1)


def update_batched(cfg: ClusterConfig, state: ClusterState, x: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor) -> ClusterState:
    """MiniBatchKMeans fold-in: μ_j ← (n_j μ_j + Σ_batch x) / (n_j + m_j)."""
    sums, cnts = _segment_sums(cfg.num_clusters, x, labels, mask)
    denom = state.counts + cnts
    new_c = torch.where(
        (cnts > 0)[:, None],
        (state.centroids * state.counts[:, None] + sums)
        / torch.clamp(denom, min=1.0)[:, None],
        state.centroids)
    return ClusterState(centroids=new_c, counts=denom)


def update_sequential(cfg: ClusterConfig, state: ClusterState,
                      x: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor) -> ClusterState:
    """Per-item EMA exactly as in Algorithm 1: η = 1/(n_j + 1). A Python
    loop of branch-free updates (no device reads)."""
    centroids = state.centroids.clone()
    counts = state.counts.clone()
    x32 = x.to(torch.float32)
    for i in range(x.shape[0]):
        li, mi = labels[i:i + 1].to(torch.int64), mask[i:i + 1]
        n = counts.index_select(0, li)
        c = centroids.index_select(0, li)
        eta = 1.0 / (n + 1.0)
        c_new = (1.0 - eta)[:, None] * c + eta[:, None] * x32[i:i + 1]
        centroids.index_copy_(0, li, torch.where(mi[:, None], c_new, c))
        counts.index_copy_(0, li, torch.where(mi, n + 1.0, n))
    return ClusterState(centroids, counts)


def update(cfg: ClusterConfig, state: ClusterState, x, labels,
           mask) -> ClusterState:
    if cfg.update_mode == "frozen":   # ablation: no clustering updates
        _, cnts = _segment_sums(cfg.num_clusters, x[:, :1], labels, mask)
        return ClusterState(state.centroids, state.counts + cnts)
    if cfg.update_mode == "sequential":
        return update_sequential(cfg, state, x, labels, mask)
    return update_batched(cfg, state, x, labels, mask)


def within_cluster_variance(state: ClusterState, x: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """Δ estimate for the paper bound: mean squared distance to the
    assigned centroid."""
    d = x.to(torch.float32) - state.centroids[labels.to(torch.int64)]
    return torch.mean(torch.sum(d * d, dim=-1))


def merge(a: ClusterState, b: ClusterState) -> ClusterState:
    """Count-weighted centroid merge of two data shards (same k):
    μ = (n_a μ_a + n_b μ_b) / (n_a + n_b), exact when the shards fold
    disjoint item sets; a cluster empty on both becomes 0.5 (μ_a + μ_b).
    (``distributed.collectives.merge_clusters`` is the sharded engine's
    rule, which keeps shard 0's centroid there.)"""
    n = a.counts + b.counts
    c = a.centroids * a.counts[:, None] + b.centroids * b.counts[:, None]
    c = torch.where((n > 0)[:, None], c / torch.clamp(n, min=1.0)[:, None],
                    0.5 * (a.centroids + b.centroids))
    return ClusterState(centroids=c, counts=n)
