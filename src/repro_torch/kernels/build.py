"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes``. Libraries go to ``build/repro_torch/`` at the repository
root, named by a hash of the sources and flags, so an unchanged source is
never rebuilt. The first use of any kernel builds all of them, one
``nvcc`` per source, all started together. Build and load hold one lock,
so two threads that reach their first launch together (an ``AsyncServer``'s
ingest and query threads) start one compile per source, not two.

No ``--use_fast_math``: it would swap the IEEE divide and sqrt the
kernels rely on for approximations.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

# the kernels, and an empty kernel that chip_smoke.py times as the launch floor
SOURCES = ("admit", "serve", "mips", "rerank", "prefilter", "assign", "bag",
           "heavy_hitter", "launch_floor")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SMEM_PER_BLOCK = 232_448   # bytes of shared memory one block can use on Hopper
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    name: str
    path: Path
    seconds: float   # compile time (0.0 when the library was already built)
    log: str         # nvcc's output, including the -Xptxas -v summary


_BUILT: dict[str, Built] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()   # guards _BUILT, _LIBS and the compiles


def nvcc_path() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Built]:
    """Compile every source whose library is missing, all in parallel;
    raise with nvcc's output if any compile fails."""
    with _LOCK:
        return _build_missing()


def _build_missing() -> dict[str, Built]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        if name in _BUILT:
            continue
        out = BUILD_DIR / f"lib{name}-{_digest(name)}.so"
        if out.exists():
            _BUILT[name] = Built(name, out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        _BUILT[name] = Built(name, out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return dict(_BUILT)


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            if name not in _BUILT:
                _build_missing()
            lib = ctypes.CDLL(str(_BUILT[name].path))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
