"""Multi-vector cosine pre-filtering (paper §Multi-Vector Cosine Pre-filtering).

Three basis instantiations (paper Table 7): ``fixed`` (Gram–Schmidt rows,
or the warmup's top-n principal directions), ``random`` (QR of a Gaussian)
and ``adaptive`` (PCA over a sliding window of the last W embeddings,
refreshed every T arrivals).

The window's write pointer, fill and arrival count are host integers: the
host knows which rows of a batch are live before it ships them, so the
refresh decision needs no device read. ``score`` is the staged screen's
scoring (the ``prefilter`` kernel); the fused ingest path scores inside
the ``admit`` kernel.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.common import host_to_device, l2_normalize
from repro_torch.kernels.prefilter.ops import prefilter_scores


@dataclasses.dataclass(frozen=True)
class PrefilterConfig:
    num_vectors: int = 5          # n (paper Table 2)
    dim: int = 384
    alpha: float = 0.2            # relevance threshold
    basis: str = "fixed"          # fixed | random | adaptive
    window: int = 1000            # W — PCA sliding window (adaptive)
    update_interval: int = 1000   # T — arrivals between basis refreshes


class PrefilterState(NamedTuple):
    basis: torch.Tensor        # [n, d] f32
    window_buf: torch.Tensor   # [W, d] f32 ring buffer (W=1 unless adaptive)
    write_ptr: int
    fill: int
    since_update: int


def _gram_schmidt(v: torch.Tensor) -> torch.Tensor:
    """Classical Gram–Schmidt, rows -> orthonormal rows."""
    basis = torch.zeros_like(v)
    for i in range(v.shape[0]):
        vi = v[i]
        vi = vi - (basis @ vi) @ basis
        basis[i] = vi / torch.clamp(torch.linalg.norm(vi), min=1e-12)
    return basis


def score(cfg: PrefilterConfig, state: PrefilterState, x: torch.Tensor):
    """(r [B] f32, keep [B] bool): keep iff mean cosine >= alpha."""
    r = prefilter_scores(x, state.basis)
    return r, r >= cfg.alpha


def _pca_topn(buf: torch.Tensor, fill: int, n: int) -> torch.Tensor:
    """Top-n *uncentered* principal directions of the first ``fill`` rows
    of the window, [n, d], sign-aligned so on-topic rows score positive."""
    W, d = buf.shape
    m = (torch.arange(W, device=buf.device) < fill).to(torch.float32)[:, None]
    xc = buf * m
    if W <= d:
        # Gram trick: eigvecs of X Xᵀ (W×W), mapped back through Xᵀ
        _, vecs = torch.linalg.eigh(xc @ xc.T)        # ascending
        dirs = xc.T @ vecs[:, -n:].flip(1)            # [d, n]
    else:
        _, vecs = torch.linalg.eigh(xc.T @ xc)
        dirs = vecs[:, -n:].flip(1)                   # [d, n]
    basis = l2_normalize(dirs.T)                      # [n, d]
    proj = torch.sum(xc @ basis.T, dim=0)             # [n]
    sign = torch.where(proj >= 0, 1.0, -1.0).to(basis.dtype)
    return basis * sign[:, None]


def init(cfg: PrefilterConfig, gen: torch.Generator,
         warmup: torch.Tensor | None = None, device=None) -> PrefilterState:
    """``warmup`` ([m, d], optional): fixed/adaptive bases start from its
    top-n principal directions; ``random`` stays data-independent."""
    n, d = cfg.num_vectors, cfg.dim
    device = gen.device if device is None else device
    g = torch.randn((n, d), generator=gen, device=device)
    if cfg.basis in ("fixed", "adaptive"):
        if warmup is not None:
            basis = _pca_topn(warmup.to(torch.float32), warmup.shape[0], n)
        else:
            basis = _gram_schmidt(l2_normalize(g))
    elif cfg.basis == "random":
        q, _ = torch.linalg.qr(g.T)      # [d, n] orthonormal columns
        basis = q.T.contiguous()
    else:
        raise ValueError(f"unknown basis {cfg.basis!r}")
    w = cfg.window if cfg.basis == "adaptive" else 1
    return PrefilterState(
        basis=basis,
        window_buf=torch.zeros((w, d), dtype=torch.float32, device=device),
        write_ptr=0, fill=0, since_update=0)


def ingest(cfg: PrefilterConfig, state: PrefilterState, x: torch.Tensor,
           mask: np.ndarray | None = None) -> PrefilterState:
    """Push a microbatch into the sliding window; refresh the basis every
    T arrivals. ``mask`` ([B] host bool, optional) drops rows (ragged
    padding) entirely: they take no ring slot and count as no arrival.
    The window is written in place. Non-adaptive bases: a no-op."""
    if cfg.basis != "adaptive":
        return state
    W = state.window_buf.shape[0]
    rows = (np.arange(x.shape[0]) if mask is None
            else np.nonzero(np.asarray(mask, bool))[0])
    n = int(rows.size)
    dest = (state.write_ptr + np.arange(n)) % W
    if n > W:   # sequential semantics: the last W rows survive
        rows, dest = rows[-W:], dest[-W:]
    if rows.size:
        state.window_buf[host_to_device(dest, x.device)] = \
            x[host_to_device(rows, x.device)].to(torch.float32)
    fill = min(state.fill + n, W)
    since = state.since_update + n
    basis = state.basis
    if since >= cfg.update_interval:
        basis, since = _pca_topn(state.window_buf, fill, cfg.num_vectors), 0
    return PrefilterState(basis, state.window_buf, (state.write_ptr + n) % W,
                          fill, since)
