"""ctypes wrapper of the hand-written CUDA ``admit`` kernel
(``repro_torch/csrc/admit.cu``): fused ingest admission in one pass."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import l2_normalize
from repro_torch.kernels.counts import COUNTS


def _fn():
    lib = build.load("admit")
    fn = lib.admit_launch
    if fn.argtypes is None:
        P, I, F = build.P, build.I, build.F
        fn.argtypes = [P, I, I, P, I, P, I, P, F, I, I, I,
                       P, P, P, P, P, P, P, P, P, P]
        fn.restype = I
    return lib, fn


def admit_cuda(x: torch.Tensor, basis: torch.Tensor, centroids: torch.Tensor,
               alpha: float, live: torch.Tensor | None = None, *,
               store_dtype: str = "fp32", normalize: bool = True,
               emit_rows: bool = True):
    """Same contract as ``ref.admit_ref``; all tensors on one CUDA device.
    The basis is normalized here on the host side of the launch with the
    reference's ``l2_normalize``, as the TPU kernel's wrapper does."""
    B, d = x.shape
    K = centroids.shape[0]
    n = basis.shape[0]
    if basis.shape[1] != d or centroids.shape[1] != d:
        raise ValueError("x, basis and centroids must share d")
    if store_dtype not in ("fp32", "int8"):
        raise ValueError(store_dtype)
    dev = x.device
    x32 = x.to(torch.float32).contiguous()
    vn = l2_normalize(basis).contiguous()
    c32 = centroids.to(torch.float32).contiguous()
    live_b = (torch.ones((B,), dtype=torch.bool, device=dev) if live is None
              else live.to(torch.bool).contiguous())
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
    if B == 0:
        return r, keep, label, sim, row, scale

    xn = torch.empty((B, d), dtype=torch.float32, device=dev)
    cn = torch.empty((K, d), dtype=torch.float32, device=dev)   # unit centroids
    keys = torch.empty((B + 1,), dtype=torch.int64, device=dev)  # + done counter
    lib, fn = _fn()
    err = fn(x32.data_ptr(), B, d, vn.data_ptr(), n, c32.data_ptr(), K,
             live_b.data_ptr(), float(alpha), int(emit_rows), int(quantized),
             int(normalize), r.data_ptr(), keep.data_ptr(), label.data_ptr(),
             sim.data_ptr(), build.ptr(row), build.ptr(scale), xn.data_ptr(),
             cn.data_ptr(), keys.data_ptr(), build.stream_of(dev))
    build.check(lib, err, "admit_launch")
    COUNTS["admit"].kernel += 1
    return r, keep, label, sim, row, scale
