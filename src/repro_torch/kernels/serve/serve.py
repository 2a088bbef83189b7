"""ctypes wrapper of the hand-written CUDA ``serve`` kernel
(``repro_torch/csrc/serve.cu``): the two-stage query in two launches,
route tiles then the routed rerank.

The ring tensors may be strided views (``embs[:, :depth]`` for a
depth-clipped plan): their strides go to the kernel, and the store is
never copied. ``serve_plan`` sizes a call from its shape alone."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import SMS, cdiv
from repro_torch.kernels.counts import COUNTS
from repro_torch.kernels.rerank.rerank import ring_cluster

ROUTE_TILE_COLS = 64       # serve.cu's kTileCols: prototypes per route tile
ROUTE_TILE_RMS = (8, 4, 2)  # route tile rows / 8, largest first


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """How one call runs: route tiles of ``8 * rm`` queries x 64
    prototypes (``ntiles`` column tiles, each keeping ``kt`` keys per
    query, ``m`` route keys per query in all), then the rerank as
    ``cluster`` blocks per query."""

    rm: int
    ntiles: int
    kt: int
    m: int
    cluster: int


def serve_plan(Q: int, cap: int, nprobe: int, depth: int) -> ServePlan:
    """The largest route tile whose grid still covers the card's SMs (the
    smallest where none does), and the rerank's cluster size."""
    if not 1 <= nprobe <= cap:
        raise ValueError(f"need 1 <= nprobe={nprobe} <= cap={cap}")
    ntiles = cdiv(cap, ROUTE_TILE_COLS)
    kt = min(nprobe, ROUTE_TILE_COLS)
    rm = next((r for r in ROUTE_TILE_RMS if ntiles * cdiv(Q, 8 * r) >= SMS),
              ROUTE_TILE_RMS[-1])
    return ServePlan(rm, ntiles, kt, ntiles * kt, ring_cluster(Q, nprobe * depth))


def _lib():
    lib = build.load("serve")
    if lib.serve_launch.argtypes is None:
        P, I, L = build.P, build.I, build.L
        lib.serve_launch.argtypes = [P, P, I, I, P, I, P, P, P, I, L, L, P, L, L, P, L, L,
                                     I, I, I, I, I, P, P, P, P, I, P]
        lib.serve_launch.restype = I
        lib.serve_smem_bytes.argtypes = [I, I, I, I, I, I]
        lib.serve_smem_bytes.restype = L
        lib.serve_route_cols.restype = I
        if lib.serve_route_cols() != ROUTE_TILE_COLS:
            raise RuntimeError("serve.cu's route tile width differs from the wrapper's")
    return lib


def serve_launcher(qr: torch.Tensor, qn: torch.Tensor, vectors: torch.Tensor,
                   valid: torch.Tensor, route_labels: torch.Tensor,
                   embs: torch.Tensor, live: torch.Tensor, k: int, nprobe: int,
                   scales: torch.Tensor | None = None, plan: ServePlan | None = None):
    """Checks, plans (``serve_plan`` unless ``plan`` is given: the card's
    tests pass one to hold every plan against the plain version) and
    allocates one call; returns (plan, scores, pos, routes, run) where
    ``run(phases)`` queues the launches (1 = route tiles, 2 = rerank, 3 =
    both) on the current stream without counting them. The wrapper runs
    both; a timing script may run them apart."""
    Q, d = qr.shape
    cap = vectors.shape[0]
    C, depth, _ = embs.shape
    quantized = embs.dtype == torch.int8
    if (scales is not None) != quantized:
        raise ValueError("int8 rings need per-slot scales; fp32 rings none")
    if not quantized and embs.dtype != torch.float32:
        raise TypeError(f"ring dtype {embs.dtype}: fp32 or int8")
    if not 1 <= k <= nprobe * depth or not 1 <= nprobe <= cap:
        raise ValueError("need 1 <= k <= nprobe*depth and nprobe <= cap")
    if embs.shape[2] != d or embs.stride(2) != 1:
        raise ValueError("ring rows must be dense along d")
    if live.dtype != torch.bool or live.shape != (C, depth):
        raise TypeError("live must be a [C, depth] bool tensor")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.shape != (C, depth)):
        raise TypeError("scales must be a [C, depth] float32 tensor")
    for t in (qr, qn, vectors, valid, route_labels):
        if not t.is_contiguous():
            raise ValueError("queries and index must be contiguous")
    if route_labels.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("route_labels i32 and valid bool")
    dev = qr.device
    plan = plan or serve_plan(Q, cap, nprobe, depth)
    scores = torch.empty((Q, k), dtype=torch.float32, device=dev)
    pos = torch.empty((Q, k), dtype=torch.int32, device=dev)
    routes = torch.empty((Q, nprobe), dtype=torch.int32, device=dev)
    if Q == 0:
        return plan, scores, pos, routes, lambda phases=3: None
    lib = _lib()
    smem = lib.serve_smem_bytes(d, plan.m, nprobe, depth, k, plan.cluster)
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"serve kernel needs {smem} B of shared memory "
                         f"(d={d}, nprobe={nprobe}, depth={depth}, k={k}), over the "
                         f"{build.SMEM_PER_BLOCK} B a block has")
    part = torch.empty((Q, plan.m), dtype=torch.int64, device=dev)   # route keys
    ss0, ss1 = (scales.stride(0), scales.stride(1)) if quantized else (0, 0)
    stream = build.stream_of(dev)

    def run(phases=3):
        build.check(lib, lib.serve_launch(
            qr.data_ptr(), qn.data_ptr(), Q, d, vectors.data_ptr(), cap,
            valid.data_ptr(), route_labels.data_ptr(), embs.data_ptr(), depth,
            embs.stride(0), embs.stride(1), live.data_ptr(), live.stride(0),
            live.stride(1), build.ptr(scales), ss0, ss1, int(quantized), k, nprobe,
            plan.rm, plan.cluster, part.data_ptr(), scores.data_ptr(), pos.data_ptr(),
            routes.data_ptr(), phases, stream), "serve_launch")
    return plan, scores, pos, routes, run


def serve_topk_cuda(qr: torch.Tensor, qn: torch.Tensor, vectors: torch.Tensor,
                    valid: torch.Tensor, route_labels: torch.Tensor,
                    embs: torch.Tensor, live: torch.Tensor, k: int,
                    nprobe: int, scales: torch.Tensor | None = None):
    """Same contract as ``ref.serve_topk_ref``; all tensors on one CUDA
    device. embs [C, depth, d] / live / scales [C, depth] may be strided
    along their leading axes; their last axis must be dense."""
    _, scores, pos, routes, run = serve_launcher(qr, qn, vectors, valid, route_labels,
                                                 embs, live, k, nprobe, scales)
    if qr.shape[0] == 0:
        return scores, pos, routes
    run()
    COUNTS["serve"].kernel += 1
    return scores, pos, routes
