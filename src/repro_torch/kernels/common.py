"""Shared helpers for the port's kernels and their plain versions.

Every kernel package under ``repro_torch/kernels/<name>/`` is a triad:
``ref.py`` (the plain PyTorch version), ``<name>.py`` (the ctypes wrapper
that launches the hand-written CUDA kernel from ``repro_torch/csrc``) and
``ops.py`` (the dispatcher: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel, anything else raises).
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = float(-1e30)


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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev

