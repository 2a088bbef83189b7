"""One run of one cell: inputs from the seed, the system built and warmed,
the measured window, then the check against the plain reference and the
metrics, each read by its own file under ``bench/metrics/``.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file found by its name in ``BENCHMARK.json``:
``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``,
``bench/limits/<cell>.json`` and ``bench/metrics/<metric>.py`` (or, for a
metric split by the end-to-end metric it moves, such as
``idle_share.query``, the reader of its stem, ``idle_share.py``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import torch

from bench import load, system
from bench.gen.synthetic import Synthetic
from bench.reference.judge import judge
from bench.reference.pipeline import Deployment

LEAD_S = 0.2     # from the end of set-up to the window's first due time


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_file(bench_dir: Path, name: str) -> Path:
    """The metric's own reader, else the reader of the part of its name
    before the first dot."""
    path = bench_dir / "metrics" / f"{name}.py"
    return path if path.exists() else (
        bench_dir / "metrics" / f"{name.split('.')[0]}.py")


def load_metric(bench_dir: Path, name: str):
    path = metric_file(bench_dir, name)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def pool_draws(rng: np.random.Generator, queries: dict, pool: int,
               n: int) -> np.ndarray:
    """``n`` indices into the query pool: uniform, or, where the traffic
    file states ``zipf_s``, rank r drawn with p ∝ 1/r^zipf_s, the ranks
    given to the pool by one permutation drawn first."""
    if "zipf_s" not in queries:
        return rng.integers(0, pool, n)
    rank_to_query = rng.permutation(pool)
    p = 1.0 / np.arange(1, pool + 1, dtype=np.float64) ** float(
        queries["zipf_s"])
    return rank_to_query[rng.choice(pool, n, p=p / p.sum())]


class Inputs:
    """Everything the run feeds the system, made from the seed. The feed
    is drawn in one way: ``_extend`` draws the next batches, their
    documents and their counter draws. Set-up draws an open-loop feed
    whole and a closed-loop one for the traffic file's ``max_docs_per_s``
    over the window (about 1.4 times the fastest run measured); a program
    that takes more gets ``CHUNK`` batches at a time as it reaches them,
    in the same order, so a faster program is never capped."""

    CHUNK = 256          # batches drawn at a time past the set-up's draw
    CHUNK_ROWS = 4096    # rows a device call then, so its scratch stays small

    def __init__(self, cfg: dict, traffic: dict, dep: Deployment, seed: int,
                 seconds: float, device: str):
        gen = self.gen = Synthetic(traffic["stream"], dep.dim, seed, device)
        self.warm = gen.docs(int(cfg["warmup_per_cluster"]) * dep.k)
        ing = traffic["ingest"]
        self.mean = float(ing["mean_batch"])
        self.prefix = int(traffic["prefix_batches"])
        self.bounds = np.zeros(1, np.int64)
        self._X, self._U, self._first = [], [], []
        if ing["mode"] == "open":
            n_win = int(math.floor(seconds * float(ing["batches_per_s"])))
            self.b_due = np.arange(n_win) / float(ing["batches_per_s"])
            self._extend(self.prefix + n_win)
            self.closed = False
        else:
            self.b_due = None
            n_win = int(math.ceil(float(ing["max_docs_per_s"]) * seconds
                                  / self.mean))
            self._extend(self.prefix + n_win)
            self.closed = True
        q = traffic.get("queries")
        self.queries = q
        if q:
            self.pool = gen.queries(int(q["pool"]))
            rng = gen.host_rng()
            rate = float(q["rate_per_s"])
            gaps = rng.exponential(1.0 / rate, int(rate * seconds * 1.2) + 1000)
            due = np.cumsum(gaps)
            self.q_due = due[due < seconds]
            self.q_idx = pool_draws(rng, q, self.pool.shape[0],
                                    self.q_due.shape[0])
            n = self.q_due.shape[0]
            self.sample = np.zeros(n, bool)
            self.sample[rng.choice(n, min(int(q["check_sample"]), n),
                                   replace=False)] = True
            self.warm_sizes = [int(s) for s in q["warm_sizes"]]

    def _extend(self, n: int, rows: int | None = None):
        sizes = self.gen.batch_sizes(n, self.mean)
        X = np.empty((int(sizes.sum()), self.gen.dim), np.float32)
        self.gen.docs_into(X, **({"rows": rows} if rows else {}))
        self._first.append(self.bounds.shape[0] - 1)
        self._X.append(X)
        self._U.append(self.gen.uniforms(X.shape[0]))
        self.bounds = np.concatenate(
            [self.bounds, self.bounds[-1] + np.cumsum(sizes)]).astype(np.int64)

    def batch(self, b: int):
        """(rows [B, d] host, first doc id, draws [B] on the device) of
        batch ``b``."""
        while b >= self.bounds.shape[0] - 1:
            if not self.closed:
                raise IndexError(f"batch {b} is past the open-loop feed")
            self._extend(self.CHUNK, self.CHUNK_ROWS)
        c = int(np.searchsorted(self._first, b, side="right")) - 1
        base = int(self.bounds[self._first[c]])
        lo, hi = int(self.bounds[b]), int(self.bounds[b + 1])
        return (self._X[c][lo - base:hi - base], lo,
                self._U[c][lo - base:hi - base])

    def docs(self, n_batches: int):
        """(every document of the first ``n_batches`` batches by id [N, d],
        their draws [N] on the host)."""
        n = int(self.bounds[n_batches])
        X = self._X[0] if len(self._X) == 1 else np.concatenate(self._X)
        U = torch.cat(self._U).cpu().numpy()
        return X[:n], U[:n]


def percentile(a: np.ndarray, p: float) -> float:
    """Nearest-rank percentile (inf where a query was never answered)."""
    s = np.sort(a)
    return float(s[max(0, int(math.ceil(p / 100.0 * s.size)) - 1)])


def window_serving(serving: dict) -> dict:
    """What the serving cache and the kernels did inside the window: the
    change of each cache counter and each kernel's launches (plain calls
    on the CPU), from the readings at its two ends."""
    a, b = serving["start"], serving["end"]
    cache = {k: b["cache"][k] - a["cache"][k]
             for k in ("hits", "misses", "hot_served", "invalidated",
                       "rekeyed", "cleared", "evicted_lru", "tier_rebuilds")}
    launches = {k: sum(b["launches"][k].values())
                - sum(a["launches"][k].values())
                for k in ("serve", "serve_route", "heavy_hitter")}
    return {"cache": cache, "launches": launches}


class Cell:
    """A cell's files, read by name from ``BENCHMARK.json``."""

    def __init__(self, root: Path, name: str):
        self.root, self.name = root, name
        self.here = root / "bench"
        self.bench = read_json(root / "BENCHMARK.json")
        self.cell = next(w for w in self.bench["workloads"]
                         if w["name"] == name)
        self.cfg = read_json(self.here / "configs" / f"{self.cell['config']}.json")
        self.traffic = read_json(self.here / "traffic"
                                 / f"{self.cell['traffic']}.json")
        self.limits = read_json(self.here / "limits" / f"{name}.json")
        self.dep = Deployment.from_file(self.cfg)


def start(c: Cell, inp: Inputs, seed: int, device: str, fault=None):
    """Build the system, ingest the prefix and publish it, warm the query
    path: (server, feed, versions)."""
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    server, pcfg = system.build(c.cfg, seed, inp.warm, device)
    if fault is not None:
        fault(server)
    dep = c.dep
    if (pcfg.clus.num_clusters, pcfg.hh.capacity) != (dep.k, dep.B):
        raise RuntimeError(f"(k, B) {pcfg.clus.num_clusters, pcfg.hh.capacity}"
                           f" differ from the deployment's {dep.k, dep.B}")
    versions = load.Versions(int(c.cfg["server"]["publish_every"]))
    feed = load.Feed(inp, versions)
    for _ in range(inp.prefix):
        feed.offer(server, [])
    server.sync(timeout=900.0)
    versions.sync()
    if inp.queries:
        for n in inp.warm_sizes:
            for i in range(n):
                server.submit(inp.pool[i % inp.pool.shape[0]])
            while server.flush():
                pass
    return server, feed, versions


def run(root: Path, cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", log=print, fault=None) -> dict:
    c = Cell(root, cell_name)
    bench, here, cfg, limits, dep = c.bench, c.here, c.cfg, c.limits, c.dep
    cuda = device == "cuda"
    inp = Inputs(cfg, c.traffic, dep, seed, seconds, device)
    server, feed, versions = start(c, inp, seed, device, fault)
    s = cfg["server"]
    rec = {"dep": dep, "server": s, "flushes": [],
           "bench_spans": [], "program_spans": [], "device_events": None}
    tracer = dtrace = None
    if trace:
        from repro_torch import obs

        from bench.trace import DeviceTrace
        n_ev = 50_000 + (int(1.5 * float(inp.queries["rate_per_s"]) * seconds)
                         if inp.queries else 0)
        _, tracer = obs.enable(metrics=False, trace=True, max_trace_events=n_ev)
        # the tracer keeps a dict an event; a full collection over them
        # stalls the request loop for tens of ms, a cost of tracing alone
        gc.collect()
        gc.disable()
        if cuda:
            dtrace = DeviceTrace()
            dtrace.start()
    serving = {"start": system.serving_counters(server)}
    if cuda:
        torch.cuda.synchronize()
    t0 = load.clock() + LEAD_S
    rec["setup_s"] = t0 - t_start
    spans = rec["bench_spans"]
    if inp.queries:
        q = load.serve_window(server, feed, t0, seconds, inp.q_due,
                              inp.pool, inp.q_idx, inp.b_due, inp.sample,
                              float(s["max_wait_ms"]) * 1e-3, spans,
                              flushes=rec["flushes"])
        rec["q"] = q
        t_end = q["t_end"]
    else:
        ing = load.ingest_window(server, feed, t0, seconds, spans)
        rec["ingest"] = ing
        t_end = ing["t_end"]
    serving["end"] = system.serving_counters(server)
    rec["serving"] = serving
    rec["window"] = (t0, t_end)
    gc.enable()
    if dtrace is not None:
        rec["device_events"] = dtrace.stop()
    if tracer is not None:
        from repro_torch import obs

        t_tr = load.clock() - tracer.now_us() * 1e-6
        chrome = tracer.to_chrome()
        rec["trace_dropped"] = int(chrome["otherData"]["dropped_events"])
        rec["program_spans"] = [
            (e["name"], t_tr + e["ts"] * 1e-6,
             t_tr + (e["ts"] + e["dur"]) * 1e-6, e.get("args", {}), e["tid"])
            for e in chrome["traceEvents"] if e.get("ph") == "X"]
        obs.disable()
    server.close(timeout=900.0)
    versions.close()
    served = server.freshness_stats()["snapshot_version"]
    if served != len(versions.at) - 1:
        raise RuntimeError(f"the server published version {served}, the "
                           f"benchmark counted {len(versions.at) - 1}")
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    sys_state = system.final_state(server)
    rec["counters"] = sys_state["counters"]
    del server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check
    answers = []
    if inp.queries:
        for j, (ids, sc, cl) in rec["q"]["answers"].items():
            answers.append({"q": inp.pool[inp.q_idx[j]], "ids": ids,
                            "scores": sc, "clusters": cl,
                            "version": int(rec["q"]["version"][j])})
    nb = feed.next
    X, U = inp.docs(nb)
    numbers, detail = judge(dep, inp.warm, seed, X, U, inp.bounds[:nb + 1],
                            versions.at, answers, sys_state)
    log(f"check detail: {json.dumps(detail, default=float)}")
    log(f"serving in the window: {json.dumps(window_serving(serving))}")
    # the cell's limits file names the numbers it compares; each must
    # have been read, and the rest go to the log only
    log("not compared: " + json.dumps(
        {k: float(v) for k, v in numbers.items() if k not in limits}))
    checks = {key: {"value": float(numbers.get(key, math.inf)),
                    "limit": float(lim)} for key, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    # ------------------------------------------------------------ metrics
    if inp.queries:
        qr = rec["q"]
        lat = (qr["answered"] - qr["due"]) * 1e3
        lat = np.where(np.isnan(lat), np.inf, lat)
        rec["query_lat_ms"] = lat
        attempted = int(lat.size)
        failed = int(np.sum(~np.isfinite(lat)))
    else:
        attempted = int(rec["ingest"]["offered"])
        failed = 0
    if trace and rec["device_events"] is not None:
        from bench.trace import busy_union

        rec["busy"] = busy_union(rec["device_events"], t0, t_end)
    kind = "per_layer" if trace else "end_to_end"
    out = {}
    for m in metrics_of(bench, cell_name, kind):
        val = load_metric(here, m["name"])(rec)
        if val is not None:
            out[m["name"]] = {"value": float(val), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": out, "checks": checks}
    result["_rec"] = rec
    return result
