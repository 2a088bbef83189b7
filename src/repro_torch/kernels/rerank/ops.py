"""Dispatcher for the routed rerank: a CPU tensor runs the plain version,
a CUDA tensor launches the kernel, anything else raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_same_device
from repro_torch.kernels.rerank.ref import rerank_topk_ref


def rerank_topk(q: torch.Tensor, embs: torch.Tensor, live: torch.Tensor,
                routes: torch.Tensor, k: int, *,
                scales: torch.Tensor | None = None):
    """Exact top-k rerank of each query's routed ring buffers: (scores
    [Q, k] f32 desc, pos [Q, k] i32 = j * depth + slot into the query's
    route list), -1 for dead entries. int8 rings need ``scales``."""
    assert 1 <= k <= routes.shape[1] * embs.shape[1], \
        "k must be in [1, nprobe * depth]"
    if check_same_device(q, embs, live, routes, scales).type == "cuda":
        from repro_torch.kernels.rerank.rerank import rerank_topk_cuda

        return rerank_topk_cuda(q, embs, live, routes, k, scales)
    return rerank_topk_ref(q, embs, live, routes, k, scales)
