"""The precision control of the check: the plain reference, computed one
precision below the deployment's (TF32 operands for its fp32 products),
put in the program's place on a cell's own inputs and judged by the same
check. A sound check reads it as not correct.

    python -m bench.control --workload <cell> --seconds <s> --seeds <n> ...

Queries are served in flushes of the front end's ``max_batch`` in due
order, each from the version published by its last query's due time
(batches reach the state at each publish); ingest falls due on its
schedule (a closed-loop cell takes
``--batches`` window batches). Prints one JSON line a seed: the numbers,
the limits, and whether the check passed.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def control_numbers(c, inp, seed: int, precision: str, n_win: int | None):
    from bench import load
    from bench.reference.judge import judge
    from bench.reference.pipeline import Replay

    dep, s = c.dep, c.cfg["server"]
    rep = Replay(dep, inp.warm, seed, precision)
    versions = load.Versions(int(s["publish_every"]))
    applied = due = 0

    def apply():
        # batches reach the state only at a publish, so that the state
        # answered from is always the last published one
        nonlocal applied
        while applied < due:
            x, lo, u = inp.batch(applied)
            rep.ingest(x, np.arange(lo, lo + x.shape[0]), u.cpu().numpy())
            applied += 1

    def ingest():
        nonlocal due
        due += 1
        n = len(versions.at)
        versions.batch()
        if len(versions.at) > n:
            apply()

    for _ in range(inp.prefix):
        ingest()
    apply()
    versions.sync()
    answers = []
    if inp.queries:
        mb, nq, bi = int(s["max_batch"]), inp.q_due.shape[0], 0
        for f0 in range(0, nq, mb):
            f1 = min(nq, f0 + mb)
            while bi < inp.b_due.shape[0] and inp.b_due[bi] <= inp.q_due[f1 - 1]:
                ingest()
                bi += 1
            sel = np.nonzero(inp.sample[f0:f1])[0] + f0
            if sel.size:
                qs = inp.pool[inp.q_idx[sel]]
                sc, ids, cl = rep.answer(qs, inp.docs(applied)[0])
                for i, j in enumerate(sel):
                    answers.append({"q": qs[i], "ids": ids[i], "scores": sc[i],
                                    "clusters": cl[i],
                                    "version": len(versions.at) - 1})
        while bi < inp.b_due.shape[0]:
            ingest()
            bi += 1
    else:
        for _ in range(n_win):
            ingest()
    apply()
    versions.close()
    X, U = inp.docs(applied)
    state = rep.final_state(X)
    return judge(dep, inp.warm, seed, X, U, inp.bounds[:applied + 1],
                 versions.at, answers, state)


def main(argv=None) -> int:
    from bench.run import ROOT, setup_env

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", default="tf32", choices=("fp32", "tf32"))
    ap.add_argument("--batches", type=int, default=None)
    args = ap.parse_args(argv)
    setup_env()
    import torch

    from bench.cell import Cell, Inputs

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    c = Cell(ROOT, args.workload)
    for seed in args.seeds:
        inp = Inputs(c.cfg, c.traffic, c.dep, seed, args.seconds, "cuda")
        numbers, detail = control_numbers(c, inp, seed, args.precision,
                                          args.batches)
        passed = all(numbers.get(k, float("inf")) <= lim
                     for k, lim in c.limits.items())
        print(json.dumps({"seed": seed, "precision": args.precision,
                          "numbers": numbers, "limits": c.limits,
                          "passed": passed, "detail": detail}, default=float))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
