"""Shared helpers for the port's kernels and their plain versions.

Every kernel package under ``repro_torch/kernels/<name>/`` is a triad:
``ref.py`` (the plain PyTorch version), ``<name>.py`` (the ctypes wrapper
that launches the hand-written CUDA kernel from ``repro_torch/csrc``) and
``ops.py`` (the dispatcher: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel, a ``meta`` tensor gets outputs of the
kernel's shapes and dtypes with nothing computed, anything else raises;
``kernels/cost.py`` models each entry's work).
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = float(-1e30)
SMS = 132   # streaming multiprocessors of an H100 SXM (the kernels size grids by it)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """fp32 L2 normalization, the reference's exact op sequence:
    ``x / max(sqrt(sum(x*x)), eps)`` — a divide, not an rsqrt."""
    x32 = x.to(torch.float32)
    n = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    return x32 / torch.clamp(n, min=eps)


def normalize_basis_rows(v: torch.Tensor) -> torch.Tensor:
    """fp32 row normalization with all-zero rows kept exactly zero:
    ``v * (1 / max(norm, 1e-12))``, the reciprocal form the ``prefilter``
    kernel's contract fixes for its pre-normalized basis (the plain
    version of that kernel's first launch). Deliberately
    not ``l2_normalize`` (a direct divide, the oracles' form): the two
    differ in the last ulp."""
    v32 = v.to(torch.float32)
    vnorm = torch.sqrt(torch.sum(v32 * v32, dim=1, keepdim=True))
    vinv = torch.where(vnorm > 0, 1.0 / torch.clamp(vnorm, min=1e-12), 0.0)
    return v32 * vinv


def stable_topk(s: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index (as
    ``lax.top_k``). ``torch.topk`` promises no tie order, so this is a
    stable descending sort cut to k."""
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


QUERY_BLOCK = 64   # rows one query-side product or reduction takes at a time


def in_query_blocks(fn, q: torch.Tensor, *per_query: torch.Tensor):
    """``fn(q, *per_query)`` over QUERY_BLOCK rows of their leading axis at
    a time (zero rows pad the last block), the results stacked back.

    How a reduction or a matmul sums a row depends on how many rows it
    takes, on a card and on the CPU alike, so a query's unit vector and
    scores would change with the queries that share its call. At one
    fixed shape they do not (row i of a block does not see the others),
    which the serving cache relies on: a sub-batch answers each query as
    the whole batch does."""
    if q.shape[0] == QUERY_BLOCK:
        return fn(q, *per_query)
    out = []
    for lo in range(0, max(q.shape[0], 1), QUERY_BLOCK):
        blk = [t[lo:lo + QUERY_BLOCK] for t in (q, *per_query)]
        m = blk[0].shape[0]
        if m < QUERY_BLOCK:
            blk = [torch.cat([t, t.new_zeros((QUERY_BLOCK - m, *t.shape[1:]))])
                   for t in blk]
        out.append(fn(*blk)[:m])
    return out[0] if len(out) == 1 else torch.cat(out)


def rowwise_dots(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``q [Q, d] . rows [..., N, d]`` -> [Q, N] fp32 scores (``rows``
    [N, d] shared, or [Q, N, d] one block per query), the plain versions'
    inner products, in query blocks (``in_query_blocks``)."""
    q32, rows32 = q.to(torch.float32), rows.to(torch.float32)
    if rows32.dim() == 2:
        return in_query_blocks(lambda qb: qb @ rows32.T, q32)
    return in_query_blocks(lambda qb, rb: torch.einsum("qd,qnd->qn", qb, rb),
                           q32, rows32)


def l2_normalize_queries(q: torch.Tensor) -> torch.Tensor:
    """``l2_normalize`` of query rows, in query blocks
    (``in_query_blocks``)."""
    return in_query_blocks(l2_normalize, q)


def require_full_fp32() -> None:
    """The reference accumulates every product in full fp32: refuse TF32
    matmuls and turn TF32 off for cuDNN."""
    assert torch.backends.cuda.matmul.allow_tf32 is False, \
        "TF32 matmuls are on; the port compares against full-fp32 sums"
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """Entry-point device policy: ``cuda`` unless the caller asks for
    another device; a missing card raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions")
    if dev.type == "cuda":
        require_full_fp32()
    return dev


def host_to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Ship a host array to ``device`` without a host-device sync: on a
    card the copy goes through pinned memory and does not block (a
    pageable copy would wait for the stream to drain)."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def check_same_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev

