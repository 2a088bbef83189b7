"""ctypes wrapper of the hand-written CUDA ``assign`` kernel
(``repro_torch/csrc/assign.cu``): nearest centroid by cosine."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import COUNTS


def _fn():
    lib = build.load("assign")
    fn = lib.assign_launch
    if fn.argtypes is None:
        P, I = build.P, build.I
        fn.argtypes = [P, I, I, P, I, P, P, P, P, P, P]
        fn.restype = I
    return lib, fn


def assign_cuda(x: torch.Tensor, centroids: torch.Tensor):
    """Same function as ``ref.assign_ref`` under the TPU kernel's
    contract (rsqrt-normalized rows and centroids); both tensors on one
    CUDA device. Returns (best_id [B] i32, best_sim [B] f32)."""
    B, d = x.shape
    K = centroids.shape[0]
    if centroids.shape[1] != d or K == 0:
        raise ValueError("x [B, d] and centroids [K >= 1, d] must share d")
    dev = x.device
    x32 = x.to(torch.float32).contiguous()
    c32 = centroids.to(torch.float32).contiguous()
    best_id = torch.empty((B,), dtype=torch.int32, device=dev)
    best_sim = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return best_id, best_sim
    lib, fn = _fn()
    xn = torch.empty((B, d), dtype=torch.float32, device=dev)
    cn = torch.empty((K, d), dtype=torch.float32, device=dev)
    keys = torch.empty((B + 1,), dtype=torch.int64, device=dev)   # + done counter
    err = fn(x32.data_ptr(), B, d, c32.data_ptr(), K, best_id.data_ptr(),
             best_sim.data_ptr(), xn.data_ptr(), cn.data_ptr(), keys.data_ptr(),
             build.stream_of(dev))
    build.check(lib, err, "assign_launch")
    COUNTS["assign"].kernel += 1
    return best_id, best_sim
