"""A copy of the benchmark with test-size cells, for the CPU tests.

``make(root)`` copies ``bench/`` and ``BENCHMARK.json`` under ``root`` and
adds, by files alone, a config ``tiny`` (d = 32, 8-slot rings, nprobe 4)
with two cells, ``tiny.query`` and ``tiny.ingest``, on the two traffic
mixes cut to a test's size, and the closed-loop ingest metrics for the
second; and a config ``tiny-cached`` (the same with a result cache
smaller than the query pool, the hot set on and a publish every batch)
with the cell ``tiny.cached``, whose queries repeat with Zipf skew 1.1
over the pool, and the serving cache's metrics. Their limits are set
from this size's readings: sound runs read 0 / 0 / ~2e-7 / ~1e-7, the
TF32 control state_diff ~30 and score_err ~3e-4."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))
LIMITS = {"label_miss": 0, "forced_miss": 0, "state_diff": 5,
          "score_err": 1e-5, "answer_gap": 1e-5}


# the closed-loop ingest cell's metrics, which no cell of BENCHMARK.json
# reports now (see PERF.md's open questions): the test copy lists them
# for tiny.ingest, as a file-only addition of that cell would
INGEST_METRICS = (
    ("end_to_end", {"name": "ingest_docs_per_s", "unit": "docs/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock"}),
    ("per_layer", {"name": "ingest_batch_ms.p50", "unit": "ms",
                   "better": "lower", "source": "program_span",
                   "layer": "ingest runtime"}),
    ("per_layer", {"name": "publish_ms.p50", "unit": "ms",
                   "better": "lower", "source": "program_span",
                   "layer": "ingest runtime"}),
    ("per_layer", {"name": "admit_roofline", "unit": "%",
                   "better": "higher", "source": "device_trace",
                   "layer": "kernels"}),
    ("per_layer", {"name": "torch_ops_ms.ingest", "unit": "ms",
                   "better": "lower", "source": "device_trace",
                   "layer": "engine stages"}),
    ("per_layer", {"name": "keep_share", "unit": "%", "better": "higher",
                   "source": "program_counter", "layer": "engine stages"}),
    ("per_layer", {"name": "idle_share.ingest", "unit": "%",
                   "better": "lower", "source": "device_trace",
                   "layer": "device"}),
)


# the cached deployment's server keys and query law, over the tiny ones
CACHED_SERVER = {"cache_entries": 24, "hotset": True, "pin_budget_mb": 0.004,
                 "hotset_refresh": 4, "publish_every": 1}
CACHED_QUERIES = {"zipf_s": 1.1}
CACHE_METRICS = (
    {"name": "cache_hit_share", "unit": "%", "better": "higher",
     "source": "program_counter", "layer": "serving cache"},
    {"name": "hot_tier_share", "unit": "%", "better": "higher",
     "source": "program_counter", "layer": "serving cache"},
)


def _dump(obj, path: Path):
    path.write_text(json.dumps(obj, indent=1))


def make(root: Path) -> Path:
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "bench/configs/srag-4gb.json").read_text())
    cfg.update(name="tiny", budget_mb=0.05, dim=32)
    cfg["pipeline"].update(store_depth=8, update_interval=64)
    cfg["server"].update(nprobe=4, topk=5, max_batch=32)
    _dump(cfg, root / "bench/configs/tiny.json")
    cached = json.loads(json.dumps(cfg))
    cached.update(name="tiny-cached")
    cached["server"].update(CACHED_SERVER)
    _dump(cached, root / "bench/configs/tiny-cached.json")
    for kind, cell in (("query", "srag-4gb.query"), ("ingest", None),
                       ("cached", "srag-4gb.query")):
        src = "ingest" if kind == "ingest" else "query"
        tr = json.loads((REPO / f"bench/traffic/{src}.json").read_text())
        tr["ingest"]["mean_batch"] = 16
        if src == "query":
            tr["prefix_batches"] = 20
            tr["ingest"]["batches_per_s"] = 8.0
            tr["queries"].update(rate_per_s=300.0, pool=64, check_sample=64,
                                 warm_sizes=[1, 32])
        if kind == "cached":
            tr["queries"].update(CACHED_QUERIES)
        _dump(tr, root / f"bench/traffic/tiny-{kind}.json")
        bench["workloads"].append({
            "name": f"tiny.{kind}",
            "config": "tiny-cached" if kind == "cached" else "tiny",
            "traffic": f"tiny-{kind}", "chips": 1, "why": "test size"})
        lim = dict(LIMITS) if src == "query" else {
            k: LIMITS[k] for k in ("label_miss", "forced_miss", "state_diff")}
        _dump(lim, root / f"bench/limits/tiny.{kind}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell in m.get("workloads", ()):
                m["workloads"].append(f"tiny.{kind}")
    for m in CACHE_METRICS:
        bench["per_layer"].append({**m, "moves": "query_p50_ms",
                                   "workloads": ["tiny.cached"]})
    for kind, m in INGEST_METRICS:
        extra = {} if kind == "end_to_end" else {"moves": "ingest_docs_per_s"}
        bench[kind].append({**m, **extra, "workloads": ["tiny.ingest"]})
    _dump(bench, root / "BENCHMARK.json")
    return root


def run(root: Path, kind: str, seed: int = 3000000001, seconds: float = 1.0,
        trace: bool = False, fault=None) -> dict:
    import time

    from bench import cell

    return cell.run(root, f"tiny.{kind}", seed, seconds, trace,
                    time.perf_counter(), device="cpu", log=lambda s: None,
                    fault=fault)
