#!/usr/bin/env python3
"""Device times of the port's kernels in two checkouts of this
repository, measured in turns on one CUDA card.

    python3 tools/kernel_ab.py OLD_CHECKOUT NEW_CHECKOUT [--kernel NAME ...]

NAME is one of ``serve`` (the default: the two-stage flush, 64 queries
against 4218 x 384 prototypes, nprobe 8, int8 rings of depth 64, k = 10;
where the checkout's wrapper exposes them, its two launches are timed
apart too, as ``serve.stage1`` and ``serve.stage2``; a checkout whose
serve starts with ``topk.cuh``'s rows_topk_kernel times that launch as
``serve.stage1``, through mips's blocked select at k = nprobe, which is
the same launch), ``mips10`` (the
streaming-RAG flush: 64 queries against 4218 x 384 prototypes, k = 10),
``mips100`` (MIND's retrieve: 4 queries against a 1,000,000 x 64 item
table, k = 100), ``rerank`` (the staged flush: the same queries, their
top-8 routes with 10% dead labels, int8 rings of depth 64, k = 10),
``bag`` (MIND's profile bag through the entry its user_vectors calls in
that checkout, at serve_p99, 512 x 50, and serve_bulk, 262,144 x 50, Zipf
ids over 1,000,000 x 64, beside ``F.embedding_bag`` + divide as
``bag.*.library``), ``assign`` and ``admit`` (a 256-row batch against
4218 x 384 centroids; admit with int8 rows); several may be given. Each
turn (A B B A, twice) is a fresh process that imports that checkout's
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
fns = {"serve": lambda: serve_topk_cuda(q, q, vectors, valid, labels, embs, live,
                                        cs.TOPK, cs.NPROBE, scales)}
from repro_torch.kernels.serve import serve as serve_mod
if hasattr(serve_mod, "serve_launcher"):   # the two launches apart
    run = serve_mod.serve_launcher(q, q, vectors, valid, labels, embs, live, cs.TOPK,
                                   cs.NPROBE, scales)[-1]
    fns["serve.stage1"] = lambda: run(1)
    fns["serve.stage2"] = lambda: run(2)
else:   # a serve whose first launch is topk.cuh's rows_topk_kernel: the same
    # launch as mips's blocked select at k = nprobe on the same index
    from repro_torch.kernels.mips.mips import mips_launcher
    plan, _, _, mrun = mips_launcher(q, vectors, valid, cs.NPROBE)
    if plan.path == "blocked":
        fns["serve.stage1"] = lambda: mrun(1)
""",
    "mips10": r"""
from repro_torch.kernels.mips.mips import mips_topk_cuda
K, d, Q = 4218, 384, cs.QUERIES
q = l2_normalize(torch.randn((Q, d), generator=g, device="cuda"))
vectors = l2_normalize(torch.randn((K, d), generator=g, device="cuda"))
valid = torch.rand((K,), generator=g, device="cuda") < 0.9
fns = {"mips10": lambda: mips_topk_cuda(q, vectors, valid, cs.TOPK)}
""",
    "mips100": r"""
from repro_torch.kernels.mips.mips import mips_topk_cuda
N, d, Q = 1_000_000, 64, 4
table = torch.randn((N, d), generator=g, device="cuda") * 0.02
q = torch.randn((Q, d), generator=g, device="cuda")
valid = torch.ones((N,), dtype=torch.bool, device="cuda")
fns = {"mips100": lambda: mips_topk_cuda(q, table, valid, 100)}
""",
    "assign": r"""
from repro_torch.kernels.assign.assign import assign_cuda
x = torch.randn((cs.BATCH, 384), generator=g, device="cuda")
cent = torch.randn((4218, 384), generator=g, device="cuda")
fns = {"assign": lambda: assign_cuda(x, cent)}
""",
    "admit": r"""
from repro_torch.kernels.admit.admit import admit_cuda
x = torch.randn((cs.BATCH, 384), generator=g, device="cuda")
basis = torch.randn((5, 384), generator=g, device="cuda")
cent = torch.randn((4218, 384), generator=g, device="cuda")
live = torch.rand((cs.BATCH,), generator=g, device="cuda") < 0.9
fns = {"admit": lambda: admit_cuda(x, basis, cent, 0.2, live, store_dtype="int8")}
""",
    "rerank": r"""
from repro_torch.kernels.rerank.rerank import rerank_topk_cuda
K, d, Q = 4218, 384, cs.QUERIES
q = l2_normalize(torch.randn((Q, d), generator=g, device="cuda"))
vectors = l2_normalize(torch.randn((K, d), generator=g, device="cuda"))
labels = torch.randperm(K, generator=g, device="cuda").to(torch.int32)
labels[torch.rand((K,), generator=g, device="cuda") < 0.1] = -1
routes = labels[torch.topk(q @ vectors.T, cs.NPROBE).indices].contiguous()
embs, live, scales = cs.synthetic_store(K, 64, d, True, g)
fns = {"rerank": lambda: rerank_topk_cuda(q, embs, live, routes, cs.TOPK, scales)}
""",
    "bag": r"""
import numpy as np
from repro_torch.kernels.bag import ops as bag_ops
# the entry MIND's user_vectors calls in this checkout (one without the
# sorted entry sorts first)
entry = getattr(bag_ops, "embedding_bag_sorted", bag_ops.embedding_bag)
table = torch.randn((1_000_000, 64), generator=g, device="cuda") * 0.02
rng = np.random.default_rng(0)
fns = {}
for label, B, S in (("bag.p99", 512, 50), ("bag.bulk", 262_144, 50)):
    mask = np.arange(S)[None, :] < rng.integers(1, S + 1, (B, 1))
    idx = torch.from_numpy(np.where(mask, cs.zipf_ids(rng, 1_000_000, (B, S)), 0)
                           .astype(np.int32)).cuda().reshape(-1)
    seg = torch.arange(B, dtype=torch.int32, device="cuda")[:, None].expand(B, S).reshape(-1)
    w = torch.from_numpy(mask).cuda().float().reshape(-1)
    offsets = torch.arange(0, B * S, S, device="cuda", dtype=torch.int32)
    fns[label] = lambda idx=idx, seg=seg, w=w, B=B: entry(table, idx, seg, B, w, "mean")
    fns[label + ".library"] = lambda idx=idx, w=w, o=offsets, S=S: (
        torch.nn.functional.embedding_bag(idx, table, o, mode="sum",
                                          per_sample_weights=w) / S)
""",
}
TIME = r"""
for name, fn in fns.items():
    out[name] = sorted(cs.cuda_ms(fn)[0] for _ in range(5))[2]
"""
ROUNDS = 2


def turn(root: str, kernels: list[str]) -> dict[str, float]:
    code = PRELUDE.format(root=os.path.abspath(root)) + "out = {}\n"
    for kernel in kernels:
        code += SETUP[kernel] + TIME
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
    times: dict[str, dict[str, list[float]]] = {}
    for _ in range(ROUNDS):
        for side in ("old", "new", "new", "old"):
            got = turn(getattr(args, side), args.kernel)
            for name, ms in got.items():
                times.setdefault(name, {"old": [], "new": []})[side].append(ms)
            print(f"{side}: " + ", ".join(f"{k} {ms:.4f}" for k, ms in got.items())
                  + " ms device")
    for name, t in times.items():
        med = {side: float(np.median(v)) if v else None for side, v in t.items()}
        if med["old"] is None or med["new"] is None:
            side = "old" if med["old"] is not None else "new"
            print(f"{name} median: {side} {med[side]:.4f} ms (the other checkout has none)")
            continue
        print(f"{name} median: old {med['old']:.4f} ms, new {med['new']:.4f} ms "
              f"({(med['new'] / med['old'] - 1) * 100:+.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
