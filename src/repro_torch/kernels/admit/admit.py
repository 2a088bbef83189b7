"""ctypes wrapper of the hand-written CUDA ``admit`` kernel
(``repro_torch/csrc/admit.cu``): fused ingest admission in two launches,
a prologue over the rows and centroids and the centroid scan."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import cdiv, round_up
from repro_torch.kernels.counts import COUNTS

PROLOGUE_WARPS = 8   # rows or centroids a prologue block takes (admit.cu)
SCRATCH_ALIGN = 256  # bytes; each scratch region starts on this boundary


@dataclasses.dataclass(frozen=True)
class AdmitPlan:
    """The prologue's grid and shared memory, and the one scratch buffer
    of a call: byte offsets of the unit rows (xn [B, d] f32), the unit
    centroids (cn [K, d] f32) and the merge keys (B + 1 words of 8 bytes:
    the keys, then the done counter)."""

    blocks: int      # prologue blocks of PROLOGUE_WARPS warps over B + K
    smem: int        # bytes: the n unit basis rows a row block holds
    xn: int
    cn: int
    keys: int
    nbytes: int


def admit_plan(B: int, K: int, n: int, d: int) -> AdmitPlan:
    """Raises ``ValueError`` where the n x d basis does not fit one
    block's shared memory."""
    smem = 4 * n * d
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"admit kernel holds the {n} x {d} basis in {smem} B of "
                         f"shared memory; a block has {build.SMEM_PER_BLOCK} B")
    xn = 0
    cn = round_up(xn + 4 * B * d, SCRATCH_ALIGN)
    keys = round_up(cn + 4 * K * d, SCRATCH_ALIGN)
    return AdmitPlan(blocks=cdiv(B + K, PROLOGUE_WARPS), smem=smem, xn=xn, cn=cn,
                     keys=keys, nbytes=keys + 8 * (B + 1))


def _fn():
    lib = build.load("admit")
    fn = lib.admit_launch
    if fn.argtypes is None:
        P, I, F = build.P, build.I, build.F
        fn.argtypes = [P, I, I, P, I, P, I, P, F, I, I, I,
                       P, P, P, P, P, P, P, P, P, I, build.L, I, P]
        fn.restype = I
    return lib, fn


def admit_launcher(x: torch.Tensor, basis: torch.Tensor, centroids: torch.Tensor,
                   alpha: float, live: torch.Tensor | None = None, *,
                   store_dtype: str = "fp32", normalize: bool = True,
                   emit_rows: bool = True):
    """Checks, plans and allocates one call; returns ((r, keep, label,
    sim, row, scale), run) where ``run(phases)`` queues the
    launches (1 = the prologue, 2 = the tile kernel, 3 = both) on the
    current stream without counting them. The wrapper runs both; a timing
    script may run them apart."""
    B, d = x.shape
    K = centroids.shape[0]
    n = basis.shape[0]
    if basis.shape[1] != d or centroids.shape[1] != d:
        raise ValueError("x, basis and centroids must share d")
    if K == 0:
        raise ValueError("admit needs at least one centroid")
    if store_dtype not in ("fp32", "int8"):
        raise ValueError(store_dtype)
    plan = admit_plan(B, K, n, d)
    dev = x.device
    x32 = x.to(torch.float32).contiguous()
    v32 = basis.to(torch.float32).contiguous()
    c32 = centroids.to(torch.float32).contiguous()
    live_b = None if live is None else live.to(torch.bool).contiguous()
    quantized = store_dtype == "int8"

    r = torch.empty((B,), dtype=torch.float32, device=dev)
    keep = torch.empty((B,), dtype=torch.bool, device=dev)
    label = torch.empty((B,), dtype=torch.int32, device=dev)
    sim = torch.empty((B,), dtype=torch.float32, device=dev)
    row = scale = None
    if emit_rows:
        row = torch.empty((B, d), dtype=torch.int8 if quantized
                          else torch.float32, device=dev)
        scale = torch.empty((B,), dtype=torch.float32, device=dev)
    out = (r, keep, label, sim, row, scale)
    if B == 0:
        return out, lambda phases=3: None

    scratch = torch.empty((plan.nbytes,), dtype=torch.uint8, device=dev)
    lib, fn = _fn()
    stream = build.stream_of(dev)

    def run(phases: int = 3) -> None:
        base = scratch.data_ptr()   # the closure holds the scratch buffer
        err = fn(x32.data_ptr(), B, d, v32.data_ptr(), n, c32.data_ptr(), K,
                 build.ptr(live_b), float(alpha), int(emit_rows), int(quantized),
                 int(normalize), r.data_ptr(), keep.data_ptr(), label.data_ptr(),
                 sim.data_ptr(), build.ptr(row), build.ptr(scale), base + plan.xn,
                 base + plan.cn, base + plan.keys, plan.blocks, plan.smem, phases,
                 stream)
        build.check(lib, err, "admit_launch")

    return out, run


def admit_cuda(x: torch.Tensor, basis: torch.Tensor, centroids: torch.Tensor,
               alpha: float, live: torch.Tensor | None = None, *,
               store_dtype: str = "fp32", normalize: bool = True,
               emit_rows: bool = True):
    """Same contract as ``ref.admit_ref``; all tensors on one CUDA device.
    The basis goes to the kernel raw (it normalizes the rows itself, with
    the reference's ``l2_normalize`` divide, as the TPU kernel's wrapper
    does before its kernel); ``live=None`` means every row is live. On
    fp32 contiguous inputs a call queues the kernel's two launches and no
    other device work."""
    out, run = admit_launcher(x, basis, centroids, alpha, live, store_dtype=store_dtype,
                              normalize=normalize, emit_rows=emit_rows)
    if x.shape[0]:
        run(3)
        COUNTS["admit"].kernel += 1
    return out
