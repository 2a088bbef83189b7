"""Dispatcher for the fused serve path (two-stage query): a CPU tensor
runs the plain version, a CUDA tensor launches the kernel, a ``meta``
tensor gets the outputs' shapes and dtypes, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.common import check_same_device
from repro_torch.kernels.serve.ref import serve_routes_ref, serve_topk_ref


def serve_topk(qr: torch.Tensor, qn: torch.Tensor, vectors: torch.Tensor,
               valid: torch.Tensor, route_labels: torch.Tensor,
               embs: torch.Tensor, ids: torch.Tensor, k: int, nprobe: int, *,
               scales: torch.Tensor | None = None, store_depth: int | None = None):
    """Fused route + gather + dequant-rerank + top-k + decode over rings
    whose slots are live where ``ids`` >= 0. Returns (scores [Q, k] f32
    desc, pos [Q, k] i32 = j * depth + slot, routes [Q, nprobe] i32, rows
    [Q, k] i32 = cluster * store_depth + slot, doc_ids [Q, k] i32, clusters
    [Q, k] i32), -1 for dead entries; ``store_depth`` (the full ring depth
    rows are encoded with) defaults to the rings' own."""
    assert 1 <= k <= nprobe * embs.shape[1], "k must be in [1, nprobe*depth]"
    dev = check_same_device(qr, qn, vectors, valid, route_labels, embs, ids, scales)

    def run():
        if dev.type == "cuda":
            from repro_torch.kernels.serve.serve import serve_topk_cuda

            return serve_topk_cuda(qr, qn, vectors, valid, route_labels, embs,
                                   ids, k, nprobe, scales, store_depth)
        if dev.type == "meta":
            Q = qn.shape[0]
            return (torch.empty((Q, k), dtype=torch.float32, device=dev),
                    torch.empty((Q, k), dtype=torch.int32, device=dev),
                    torch.empty((Q, nprobe), dtype=torch.int32, device=dev),
                    *(torch.empty((Q, k), dtype=torch.int32, device=dev)
                      for _ in range(3)))
        return serve_topk_ref(qr, qn, vectors, valid, route_labels, embs, ids,
                              k, nprobe, scales, store_depth)

    Q, d = qn.shape
    return cost.entry("serve", run, lambda out: cost.serve(
        Q, d, vectors.shape[0], embs.shape[1], nprobe, k, embs.element_size(),
        embs.dtype == torch.int8, cost.distinct(out[2])))


def serve_routes(qr: torch.Tensor, vectors: torch.Tensor, valid: torch.Tensor,
                 route_labels: torch.Tensor, nprobe: int) -> torch.Tensor:
    """Stage 1 of ``serve_topk`` alone: the routes [Q, nprobe] i32 it
    serves through, in its order (-1 where dead)."""
    dev = check_same_device(qr, vectors, valid, route_labels)

    def run():
        if dev.type == "cuda":
            from repro_torch.kernels.serve.serve import serve_routes_cuda

            return serve_routes_cuda(qr, vectors, valid, route_labels, nprobe)
        if dev.type == "meta":
            return torch.empty((qr.shape[0], nprobe), dtype=torch.int32, device=dev)
        return serve_routes_ref(qr, vectors, valid, route_labels, nprobe)

    Q, d = qr.shape
    return cost.entry("serve_route", run, lambda out: cost.serve_route(
        Q, d, vectors.shape[0], nprobe))
