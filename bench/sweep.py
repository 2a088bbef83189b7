"""The knee sweep of a query cell: one set-up, then a window at each rate
in turn, printing each window's latency percentiles and whether the
backlog grew (the last third's p95 against the first third's).

    python -m bench.sweep --workload <cell> --seed <n> --seconds <s> --rates <r> ...

The knee is the highest rate whose p95 stays within the limit without a
growing backlog in every process tried (run the sweep in three fresh
processes or more, the rates in another order in each); the cell's
traffic file states 0.8 of it as its rate. Each line also gives the
percentiles of the window's two halves, to compare window lengths.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    from bench.run import ROOT, setup_env

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    setup_env()
    import torch

    from bench import load
    from bench.cell import Cell, Inputs, percentile, pool_draws, start

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    c = Cell(ROOT, args.workload)
    inp = Inputs(c.cfg, c.traffic, c.dep, args.seed,
                 args.seconds * len(args.rates), "cuda")
    server, feed, _ = start(c, inp, args.seed, "cuda")
    rng = np.random.default_rng(args.seed)
    bps = float(c.traffic["ingest"]["batches_per_s"])
    b_due = np.arange(int(args.seconds * bps)) / bps
    wait = float(c.cfg["server"]["max_wait_ms"]) * 1e-3
    for rate in args.rates:
        due = np.cumsum(rng.exponential(1.0 / rate,
                                        int(rate * args.seconds * 1.2) + 1000))
        due = due[due < args.seconds]
        idx = pool_draws(rng, c.traffic["queries"], inp.pool.shape[0],
                         due.shape[0])
        fl = []
        t0 = load.clock() + 0.2
        q = load.serve_window(server, feed, t0, args.seconds, due, inp.pool,
                              idx, b_due, np.zeros(due.shape[0], bool), wait,
                              [], fl)
        lat = (q["answered"] - q["due"]) * 1e3
        lat = np.where(np.isnan(lat), np.inf, lat)
        third, half = lat.size // 3, lat.size // 2
        late = q["answered"] > q["t_end"]
        print(json.dumps({
            "rate": rate, "queries": int(lat.size),
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "p99_ms": percentile(lat, 99),
            "p95_first_third_ms": percentile(lat[:third], 95),
            "p95_last_third_ms": percentile(lat[-third:], 95),
            "p50_halves_ms": [percentile(lat[:half], 50),
                              percentile(lat[half:], 50)],
            "p95_halves_ms": [percentile(lat[:half], 95),
                              percentile(lat[half:], 95)],
            "answered_after_window": int(late.sum()),
            "mean_flush": float(np.mean([n for _, _, n in fl])),
            "flushes": len(fl)}))
        sys.stdout.flush()
    server.close(timeout=900.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
