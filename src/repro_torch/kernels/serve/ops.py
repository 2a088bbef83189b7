"""Dispatcher for the fused serve path (two-stage query): a CPU tensor
runs the plain version, a CUDA tensor launches the kernel, anything else
raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_same_device
from repro_torch.kernels.serve.ref import serve_routes_ref, serve_topk_ref


def serve_topk(qr: torch.Tensor, qn: torch.Tensor, vectors: torch.Tensor,
               valid: torch.Tensor, route_labels: torch.Tensor,
               embs: torch.Tensor, live: torch.Tensor, k: int, nprobe: int, *,
               scales: torch.Tensor | None = None):
    """Fused route + gather + dequant-rerank + top-k. Returns (scores
    [Q, k] f32 desc, pos [Q, k] i32 = j * depth + slot, routes [Q, nprobe]
    i32), -1 for dead entries."""
    assert 1 <= k <= nprobe * embs.shape[1], "k must be in [1, nprobe*depth]"
    if check_same_device(qr, qn, vectors, valid, route_labels, embs, live,
                         scales).type == "cuda":
        from repro_torch.kernels.serve.serve import serve_topk_cuda

        return serve_topk_cuda(qr, qn, vectors, valid, route_labels, embs,
                               live, k, nprobe, scales)
    return serve_topk_ref(qr, qn, vectors, valid, route_labels, embs, live,
                          k, nprobe, scales)


def serve_routes(qr: torch.Tensor, vectors: torch.Tensor, valid: torch.Tensor,
                 route_labels: torch.Tensor, nprobe: int) -> torch.Tensor:
    """Stage 1 of ``serve_topk`` alone: the routes [Q, nprobe] i32 it
    serves through, in its order (-1 where dead)."""
    if check_same_device(qr, vectors, valid, route_labels).type == "cuda":
        from repro_torch.kernels.serve.serve import serve_routes_cuda

        return serve_routes_cuda(qr, vectors, valid, route_labels, nprobe)
    return serve_routes_ref(qr, vectors, valid, route_labels, nprobe)
