"""Dispatcher for the routed rerank: a CPU tensor runs the plain version,
a CUDA tensor launches the kernel, a ``meta`` tensor gets the outputs'
shapes and dtypes, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.common import check_same_device
from repro_torch.kernels.rerank.ref import rerank_topk_ref


def rerank_topk(q: torch.Tensor, embs: torch.Tensor, ids: torch.Tensor,
                routes: torch.Tensor, k: int, *,
                scales: torch.Tensor | None = None):
    """Exact top-k rerank of each query's routed ring buffers: (scores
    [Q, k] f32 desc, pos [Q, k] i32 = j * depth + slot into the query's
    route list), -1 for dead entries; a slot is live where its ``ids``
    entry is >= 0. int8 rings need ``scales``."""
    assert 1 <= k <= routes.shape[1] * embs.shape[1], \
        "k must be in [1, nprobe * depth]"
    dev = check_same_device(q, embs, ids, routes, scales)

    def run():
        if dev.type == "cuda":
            from repro_torch.kernels.rerank.rerank import rerank_topk_cuda

            return rerank_topk_cuda(q, embs, ids, routes, k, scales)
        if dev.type == "meta":
            Q = q.shape[0]
            return (torch.empty((Q, k), dtype=torch.float32, device=dev),
                    torch.empty((Q, k), dtype=torch.int32, device=dev))
        return rerank_topk_ref(q, embs, ids, routes, k, scales)

    Q, d = q.shape
    return cost.entry("rerank", run, lambda out: cost.rerank(
        Q, d, routes.shape[1], embs.shape[1], k, embs.element_size(),
        embs.dtype == torch.int8, cost.distinct(routes)))
