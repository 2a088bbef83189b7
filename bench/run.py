"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one run of
one cell.

    python -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It needs a CUDA card (it exits with 2
and prints no result without one), builds the port's kernels into the
checkout's ``build/repro_torch/`` on first use, and prints, as the last
line of its standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced, the
``breakdown``; last in it, ``checks``: each number the check compared,
beside its limit. The same numbers end its standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def setup_env() -> None:
    """Caches inside the checkout at fixed paths, one host thread for the
    math libraries, and no library that loads JAX."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")   # one process, few threads
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_env()
    import torch

    from bench import cell

    bench = cell.read_json(ROOT / "BENCHMARK.json")
    w = [c for c in bench["workloads"] if c["name"] == args.workload]
    if not w:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < w[0]["chips"]:
        print("no CUDA device (or fewer than the cell needs): no result",
              file=sys.stderr)
        return 2
    res = cell.run(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), T_START,
                   log=lambda s: print(s, file=sys.stderr))
    rec = res.pop("_rec")
    bad = forbidden_modules()
    if bad:
        print(f"modules that must not load were loaded: {bad}", file=sys.stderr)
        return 3
    res["device"] = device_info(torch, rec, bool(args.trace))
    if args.trace:
        res["breakdown"] = breakdown(rec)
        res["trace_dropped"] = rec.get("trace_dropped", 0)
    checks = res.pop("checks")
    res["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res))
    sys.stdout.flush()
    return 0


def device_info(torch, rec: dict, trace: bool) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": int(rec["peak_bytes"])}
    if trace:
        t0, t1 = rec["window"]
        out["busy_s"] = sum(b - a for a, b in rec["busy"])
        out["window_s"] = t1 - t0
    return out


def breakdown(rec: dict) -> dict:
    from bench.trace import device_ops, idle_gaps

    t0, t1 = rec["window"]
    main = threading.main_thread().ident
    spans = [(*s, main) for s in rec["bench_spans"]]
    spans += [(*s[:3], s[4]) for s in rec["program_spans"] if s[0] != "query"]
    return {"device_ops": device_ops(rec["device_events"], t0, t1),
            "idle_gaps": idle_gaps(rec["busy"], spans, t0, t1)}


if __name__ == "__main__":
    sys.exit(main())
