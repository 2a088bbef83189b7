"""ctypes wrapper of the hand-written CUDA ``rerank`` kernel
(``repro_torch/csrc/rerank.cu``): exact top-k over each query's routed
ring buffers, a cluster of blocks per query.

The ring tensors may be strided views (``embs[:, :depth]`` for a
depth-clipped plan): their strides go to the kernel, and the store is
never copied. ``ring_cluster`` sizes the clusters for this kernel and for
serve's rerank stage, which share ``csrc/rings.cuh``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import SMS, cdiv
from repro_torch.kernels.counts import COUNTS

RING_MAX_CLUSTER = 8     # rings.cuh's kMaxCluster (the portable cluster size)
RING_MIN_SHARE = 64      # candidates each block of a cluster scores at least
RING_WARPS = 8           # rings.cuh's kRingWarps (256 threads a block)


def ring_cluster(Q: int, ncand: int) -> int:
    """Blocks per query (1, 2, 4 or 8): doubled while the Q * cs blocks
    still fit one wave on the card's SMs (a ring block of 256 threads
    holds about 150 registers a thread, so one runs to an SM) and each
    block keeps at least RING_MIN_SHARE of the query's ``ncand``
    candidates."""
    cs = 1
    while (cs < RING_MAX_CLUSTER and 2 * cs * Q <= SMS
           and ncand >= 2 * cs * RING_MIN_SHARE):
        cs *= 2
    return cs


def warp_keep(n: int, k: int) -> int:
    """rings.cuh's ``warp_keep``: the keys a warp keeps of n."""
    return min(k, cdiv(n, RING_WARPS))


def ring_smem_bytes(d: int, nprobe: int, depth: int, k: int, cs: int, m: int = 0) -> int:
    """rings.cuh's ``ring_smem(...).bytes``: one ring block's shared memory
    (its share of the candidates and their lists, the leader's gather of
    the cluster's lists, ``m`` route keys and their lists for serve, the
    query and its routes). The wrappers check it against the library's
    own figure."""
    nmax = cdiv(nprobe * depth, cs)
    keys = (nmax + RING_WARPS * warp_keep(nmax, k) + (cs * min(k, nmax) if cs > 1 else 0)
            + m + (RING_WARPS * warp_keep(m, nprobe) if m else 0))
    return 8 * keys + 4 * d + 4 * nprobe


def _fn():
    lib = build.load("rerank")
    fn = lib.rerank_launch
    if fn.argtypes is None:
        P, I, L = build.P, build.I, build.L
        fn.argtypes = [P, I, I, P, I, I, P, I, L, L, P, L, L, P, L, L, I, I, I,
                       P, P, P]
        fn.restype = I
        lib.rerank_smem_bytes.argtypes = [I, I, I, I, I]
        lib.rerank_smem_bytes.restype = L
    return lib, fn


def rerank_topk_cuda(q: torch.Tensor, embs: torch.Tensor, ids: torch.Tensor,
                     routes: torch.Tensor, k: int,
                     scales: torch.Tensor | None = None, *, cluster: int | None = None):
    """Same contract as ``ref.rerank_topk_ref``; all tensors on one CUDA
    device. q [Q, d] f32 and routes [Q, nprobe] i32 contiguous; embs
    [C, depth, d] / ids / scales [C, depth] may be strided along their
    leading axes; their last axis must be dense. ``cluster`` (blocks per
    query) defaults to ``ring_cluster``'s pick; the card's tests pass it to
    hold every cluster size against the plain version."""
    Q, d = q.shape
    C, depth, _ = embs.shape
    nprobe = routes.shape[1]
    quantized = embs.dtype == torch.int8
    if (scales is not None) != quantized:
        raise ValueError("int8 rings need per-slot scales; fp32 rings none")
    if not quantized and embs.dtype != torch.float32:
        raise TypeError(f"ring dtype {embs.dtype}: fp32 or int8")
    if q.dtype != torch.float32 or routes.dtype != torch.int32:
        raise TypeError("q must be float32 and routes int32")
    if not (q.is_contiguous() and routes.is_contiguous()):
        raise ValueError("q and routes must be contiguous")
    if routes.shape[0] != Q or not 1 <= k <= nprobe * depth:
        raise ValueError("need routes [Q, nprobe] and 1 <= k <= nprobe*depth")
    if embs.shape[2] != d or embs.stride(2) != 1:
        raise ValueError("ring rows must be dense along d")
    if ids.dtype != torch.int32 or ids.shape != (C, depth):
        raise TypeError("ids must be a [C, depth] int32 tensor")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.shape != (C, depth)):
        raise TypeError("scales must be a [C, depth] float32 tensor")
    dev = q.device
    scores = torch.empty((Q, k), dtype=torch.float32, device=dev)
    pos = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return scores, pos
    cs = cluster or ring_cluster(Q, nprobe * depth)
    lib, fn = _fn()
    smem = lib.rerank_smem_bytes(d, nprobe, depth, k, cs)
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"rerank kernel needs {smem} B of shared memory "
                         f"(d={d}, nprobe={nprobe}, depth={depth}, k={k}), over the "
                         f"{build.SMEM_PER_BLOCK} B a block has")
    ss0, ss1 = (scales.stride(0), scales.stride(1)) if quantized else (0, 0)
    err = fn(q.data_ptr(), Q, d, routes.data_ptr(), nprobe, C, embs.data_ptr(),
             depth, embs.stride(0), embs.stride(1), ids.data_ptr(),
             ids.stride(0), ids.stride(1), build.ptr(scales), ss0, ss1,
             int(quantized), k, cs, scores.data_ptr(), pos.data_ptr(),
             build.stream_of(dev))
    build.check(lib, err, "rerank_launch")
    COUNTS["rerank"].kernel += 1
    return scores, pos
