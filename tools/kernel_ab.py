#!/usr/bin/env python3
"""Device times of the port's kernels in two checkouts of this
repository, measured in turns on one CUDA card.

    python3 tools/kernel_ab.py OLD_CHECKOUT NEW_CHECKOUT [--kernel NAME ...]

NAME is one of ``serve`` (the default), ``mips10`` (the streaming-RAG
flush: 64 queries against 4218 x 384 prototypes, k = 10), ``mips100``
(MIND's retrieve: 4 queries against a 1,000,000 x 64 item table, k =
100), ``assign`` and ``admit`` (a 256-row batch against 4218 x 384
centroids; admit with int8 rows); several may be given. Each turn (A B
B A, twice) is a fresh process that imports that checkout's
``chip_smoke.py`` (and with it that checkout's
``src/repro_torch``), builds the kernels from its sources into the
checkout's own ``build/``, and times each kernel's public wrapper with
``chip_smoke.cuda_ms`` (CUDA events around warm calls queued behind a
spinning kernel; the median of 5). Inputs are made on the card from a
fixed seed, the same in every turn. Prints one line per turn and the
median of each side. Two versions are comparable only inside one such
run: cards and their power limits differ between machines.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

PRELUDE = r"""
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels.common import l2_normalize
g = torch.Generator(device="cuda"); g.manual_seed(0)
"""
SETUP = {
    "serve": r"""
from repro_torch.kernels.serve.serve import serve_topk_cuda
K, d, Q = 4218, 384, cs.QUERIES
q = l2_normalize(torch.randn((Q, d), generator=g, device="cuda"))
vectors = l2_normalize(torch.randn((K, d), generator=g, device="cuda"))
valid = torch.rand((K,), generator=g, device="cuda") < 0.9
labels = torch.randperm(K, generator=g, device="cuda").to(torch.int32)
labels[torch.rand((K,), generator=g, device="cuda") < 0.1] = -1
embs, live, scales = cs.synthetic_store(K, 64, d, True, g)
fn = lambda: serve_topk_cuda(q, q, vectors, valid, labels, embs, live,
                             cs.TOPK, cs.NPROBE, scales)
""",
    "mips10": r"""
from repro_torch.kernels.mips.mips import mips_topk_cuda
K, d, Q = 4218, 384, cs.QUERIES
q = l2_normalize(torch.randn((Q, d), generator=g, device="cuda"))
vectors = l2_normalize(torch.randn((K, d), generator=g, device="cuda"))
valid = torch.rand((K,), generator=g, device="cuda") < 0.9
fn = lambda: mips_topk_cuda(q, vectors, valid, cs.TOPK)
""",
    "mips100": r"""
from repro_torch.kernels.mips.mips import mips_topk_cuda
N, d, Q = 1_000_000, 64, 4
table = torch.randn((N, d), generator=g, device="cuda") * 0.02
q = torch.randn((Q, d), generator=g, device="cuda")
valid = torch.ones((N,), dtype=torch.bool, device="cuda")
fn = lambda: mips_topk_cuda(q, table, valid, 100)
""",
    "assign": r"""
from repro_torch.kernels.assign.assign import assign_cuda
x = torch.randn((cs.BATCH, 384), generator=g, device="cuda")
cent = torch.randn((4218, 384), generator=g, device="cuda")
fn = lambda: assign_cuda(x, cent)
""",
    "admit": r"""
from repro_torch.kernels.admit.admit import admit_cuda
x = torch.randn((cs.BATCH, 384), generator=g, device="cuda")
basis = torch.randn((5, 384), generator=g, device="cuda")
cent = torch.randn((4218, 384), generator=g, device="cuda")
live = torch.rand((cs.BATCH,), generator=g, device="cuda") < 0.9
fn = lambda: admit_cuda(x, basis, cent, 0.2, live, store_dtype="int8")
""",
}
TIME = r"""
ms = [cs.cuda_ms(fn)[0] for _ in range(5)]
out[{kernel!r}] = sorted(ms)[2]
"""
ROUNDS = 2


def turn(root: str, kernels: list[str]) -> dict[str, float]:
    code = PRELUDE.format(root=os.path.abspath(root)) + "out = {}\n"
    for kernel in kernels:
        code += SETUP[kernel] + TIME.format(kernel=kernel)
    code += "print(json.dumps(out))\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--kernel", nargs="+", choices=sorted(SETUP), default=["serve"])
    args = ap.parse_args()
    times = {k: {"old": [], "new": []} for k in args.kernel}
    for _ in range(ROUNDS):
        for side in ("old", "new", "new", "old"):
            got = turn(getattr(args, side), args.kernel)
            for kernel, ms in got.items():
                times[kernel][side].append(ms)
            print(f"{side}: " + ", ".join(f"{k} {ms:.4f}" for k, ms in got.items())
                  + " ms device")
    for kernel, t in times.items():
        med = {side: float(np.median(v)) for side, v in t.items()}
        print(f"{kernel} median: old {med['old']:.4f} ms, new {med['new']:.4f} ms "
              f"({(med['new'] / med['old'] - 1) * 100:+.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
