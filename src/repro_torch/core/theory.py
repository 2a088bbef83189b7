"""Empirical validation of the paper's retrieval guarantee (§Theoretical
Retrieval Guarantees):

    E[R(K_t)] >= R* − L·Δ,

with R the Lipschitz retrieval score, R* the optimal score on the full
corpus, and Δ the within-cluster variance bound.

For cosine retrieval with unit-norm queries, r(x) = q·x̂ is 1-Lipschitz in x̂
(|q·a − q·b| <= ‖q‖‖a−b‖), so L = 1 under unit normalization. The paper's
proof sketch derives the per-item perturbation L·√Δ; both forms are
evaluated (the √Δ form is the mathematically valid one; the paper's LΔ
statement holds whenever Δ <= √Δ, i.e. Δ <= 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.common import l2_normalize


class BoundReport(NamedTuple):
    r_star: torch.Tensor        # optimal retrieval score, full corpus
    r_proto: torch.Tensor       # retrieval score with prototypes K_t
    delta: torch.Tensor         # within-cluster variance (mean ‖x−μ‖²)
    lipschitz: float            # L (1.0 for unit-norm cosine)
    bound_sqrt: torch.Tensor    # R* − L·√Δ  (proof-sketch form)
    bound_linear: torch.Tensor  # R* − L·Δ  (paper-statement form)
    holds_sqrt: torch.Tensor
    holds_linear: torch.Tensor


def retrieval_score(queries: torch.Tensor, items: torch.Tensor,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """R(·): mean over queries of the best cosine achievable in ``items``."""
    s = l2_normalize(queries) @ l2_normalize(items).T
    if valid is not None:
        s = torch.where(valid[None, :], s, -torch.inf)
    return torch.mean(torch.max(s, dim=1).values)


def check_bound(queries: torch.Tensor, corpus: torch.Tensor,
                centroids: torch.Tensor, labels: torch.Tensor,
                valid_centroids: torch.Tensor | None = None) -> BoundReport:
    """Evaluate E[R(K_t)] >= R* − L·Δ on concrete data; ``labels`` maps each
    corpus item to its centroid (for Δ)."""
    r_star = retrieval_score(queries, corpus)
    r_proto = retrieval_score(queries, centroids, valid_centroids)
    diff = l2_normalize(corpus) - l2_normalize(centroids)[labels.to(torch.int64)]
    delta = torch.mean(torch.sum(diff * diff, dim=-1))
    L = 1.0
    b_sqrt = r_star - L * torch.sqrt(delta)
    b_lin = r_star - L * delta
    return BoundReport(
        r_star=r_star, r_proto=r_proto, delta=delta, lipschitz=L,
        bound_sqrt=b_sqrt, bound_linear=b_lin,
        holds_sqrt=r_proto >= b_sqrt - 1e-6,
        holds_linear=r_proto >= b_lin - 1e-6)


def state_change_rate(total_writes, n, p: float = 2.0):
    """Jayaram et al. accounting: writes vs the Ω(n^{1−1/p}) lower bound.
    Returns (writes, lower_bound, ratio) as f32 tensors; the counter
    matches the bound up to polylog factors when ratio stays O(polylog n)."""
    n32 = torch.as_tensor(n).to(torch.float32)
    lb = torch.pow(torch.clamp(n32, min=1.0), 1.0 - 1.0 / p)
    w = torch.as_tensor(total_writes).to(torch.float32)
    return w, lb, w / torch.clamp(lb, min=1.0)
