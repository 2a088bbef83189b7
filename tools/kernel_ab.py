#!/usr/bin/env python3
"""Device time of the port's ``serve`` kernel in two checkouts of this
repository, measured in turns on one CUDA card.

    python3 tools/kernel_ab.py OLD_CHECKOUT NEW_CHECKOUT

Each turn (A B B A, twice) is a fresh process that imports that
checkout's ``chip_smoke.py`` (and with it that checkout's
``src/repro_torch``), builds the kernel from its sources into the
checkout's own ``build/``, and times it at the main path's shapes with
``chip_smoke.cuda_ms`` (CUDA events around warm calls queued behind a
spinning kernel). Inputs are made on the card from a fixed seed, the same
in every turn. Prints one line per turn and the median of each side.
Two versions are comparable only inside one such run: cards and their
power limits differ between machines.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

TURN = r"""
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels.common import l2_normalize
from repro_torch.kernels.serve.serve import serve_topk_cuda
g = torch.Generator(device="cuda"); g.manual_seed(0)
K, d, Q = 4218, 384, cs.QUERIES
q = l2_normalize(torch.randn((Q, d), generator=g, device="cuda"))
vectors = l2_normalize(torch.randn((K, d), generator=g, device="cuda"))
valid = torch.rand((K,), generator=g, device="cuda") < 0.9
labels = torch.randperm(K, generator=g, device="cuda").to(torch.int32)
labels[torch.rand((K,), generator=g, device="cuda") < 0.1] = -1
embs, live, scales = cs.synthetic_store(K, 64, d, True, g)
fn = lambda: serve_topk_cuda(q, q, vectors, valid, labels, embs, live,
                             cs.TOPK, cs.NPROBE, scales)
ms = [cs.cuda_ms(fn)[0] for _ in range(5)]
print(json.dumps({{"ms": sorted(ms)[2]}}))
"""


ROUNDS = 2


def turn(root: str) -> float:
    code = TURN.format(root=os.path.abspath(root))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])["ms"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args()
    times = {"old": [], "new": []}
    for _ in range(ROUNDS):
        for side in ("old", "new", "new", "old"):
            ms = turn(getattr(args, side))
            times[side].append(ms)
            print(f"serve {side}: {ms:.4f} ms device")
    med = {side: float(np.median(v)) for side, v in times.items()}
    print(f"serve median: old {med['old']:.4f} ms, new {med['new']:.4f} ms "
          f"({(med['new'] / med['old'] - 1) * 100:+.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
