"""The port's observability subsystem (``tests/test_obs.py`` on
``repro_torch``), and its instrument and span names held against the JAX
package's on the same run.

* registry semantics: idempotent instruments, exact counters under
  threads, log-bucket histogram percentiles, JSON + Prometheus export;
* the on/off contract: with observability disabled the serving path
  creates no instruments and never touches the device-counter fetch;
  enabled, the device counters are fetched at publish time ONLY — never
  from the query path (the "zero device syncs on queries" property);
* trace export: a threaded async serving run produces a structurally
  valid Chrome trace-event JSON whose per-query spans carry the snapshot
  version they were answered from (correlated against actual publishes);
* satellite fixes: per-query latency window (p90 + window sizes in
  ``latency_stats``), wall-clock snapshot age with the never-published
  guard, and stat exactness under concurrent submit/flush;
* the names: a cached, durable async run with a crash and recovery
  records the same metric and span names in both packages;
* ``obs.kern``: CUDA-event/host timing into the registry, and the
  modeled HLO cost, which waits on ROADMAP A10, raises.

The reference's jit-trace counting (``count_kernel_trace``) has no
counterpart: the port traces nothing per shape.
"""
import faulthandler
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import clustering, heavy_hitter, pipeline, prefilter
from repro_torch.data.streams import make_stream
from repro_torch.engine.engine import Engine
from repro_torch.obs import kern
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import Tracer, validate_chrome_trace
from repro_torch.serve.runtime import AsyncServer, QueryFrontend, ServerConfig

DIM = 32
WATCHDOG_S = 240.0

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(autouse=True)
def _deadlock_watchdog():
    def _die():
        faulthandler.dump_traceback(file=sys.stderr)
        os._exit(3)

    timer = threading.Timer(WATCHDOG_S, _die)
    timer.daemon = True
    timer.start()
    yield
    timer.cancel()


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Each test starts disabled with no inherited instruments (CI runs
    this module under REPRO_OBS=1, which enables at import time)."""
    was = obs.enabled()
    obs.disable()
    yield
    obs.disable()
    if was:
        obs.enable()


def small_cfg(**kw):
    return pipeline.PipelineConfig(
        pre=prefilter.PrefilterConfig(num_vectors=3, dim=DIM, alpha=0.0,
                                      basis="fixed"),
        clus=clustering.ClusterConfig(num_clusters=16, dim=DIM),
        hh=heavy_hitter.HHConfig(capacity=8, admit_prob=0.5),
        update_interval=kw.pop("update_interval", 64),
        **kw)


# ------------------------------------------------------------------ registry
def test_registry_instruments_are_idempotent_and_typed():
    reg = Registry()
    c = reg.counter("a_total")
    assert reg.counter("a_total") is c
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    g = reg.gauge("depth")
    g.set(7)
    g.add(-2)
    assert g.value == 5.0
    with pytest.raises(AssertionError):
        reg.gauge("a_total")  # kind mismatch must not silently alias


def test_histogram_percentiles_bracket_the_data():
    reg = Registry()
    h = reg.histogram("lat_ms", unit="ms", lo=0.01, hi=1e4, nbuckets=96)
    vals = np.concatenate([np.full(90, 1.0), np.full(9, 50.0),
                           np.full(1, 900.0)])
    for v in vals:
        h.observe(float(v))
    snap = h.snapshot()
    assert snap["count"] == 100
    assert snap["min"] == 1.0 and snap["max"] == 900.0
    assert abs(snap["mean"] - float(np.mean(vals))) < 1e-9
    # bucket-resolution percentiles: upper bound of the right bucket,
    # within one geometric step of the true value
    growth = (1e4 / 0.01) ** (1 / 95)
    # nearest-rank semantics: 90% of observations are <= 1.0
    assert 1.0 <= snap["p50"] <= 1.0 * growth
    assert 1.0 <= snap["p90"] <= 1.0 * growth
    assert 50.0 <= snap["p99"] <= 50.0 * growth
    assert 900.0 <= h.percentile(99.5) <= 900.0
    # exact ends via tracked min/max
    assert h.percentile(0) == 1.0 and h.percentile(100) == 900.0


def test_counter_exact_under_concurrent_increments():
    reg = Registry()
    c = reg.counter("hits_total")
    n_threads, per_thread = 8, 2000

    def work():
        for _ in range(per_thread):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n_threads * per_thread  # no lost += interleavings


def test_json_and_prometheus_export():
    reg = Registry()
    reg.counter("q_total", help="queries").inc(5)
    reg.gauge("depth").set(3)
    h = reg.histogram("lat", unit="ms")
    for v in (0.5, 2.0, 80.0):
        h.observe(v)
    reg.set_many("pipeline_", {"arrivals": 10, "admit_rate": 0.4})

    out = json.loads(reg.to_json())
    assert out["counters"]["q_total"] == 5.0
    assert out["gauges"]["pipeline_arrivals"] == 10.0
    assert out["gauges"]["pipeline_admit_rate"] == 0.4
    assert out["histograms"]["lat"]["count"] == 3

    prom = reg.to_prometheus()
    assert "# TYPE q_total counter" in prom
    assert "q_total 5" in prom
    assert "# TYPE lat histogram" in prom
    assert 'lat_bucket{le="+Inf"} 3' in prom
    assert "lat_count 3" in prom
    # _bucket lines are cumulative and non-decreasing
    runs = [int(line.rsplit(" ", 1)[1]) for line in prom.splitlines()
            if line.startswith("lat_bucket")]
    assert runs == sorted(runs) and runs[-1] == 3


# -------------------------------------------------------------------- tracer
def test_tracer_chrome_export_is_valid_and_bounded():
    tr = Tracer(max_events=4)
    with tr.span("outer", cat="t", a=1) as sp:
        sp.args["b"] = 2          # mid-span correlation fill-in
        tr.instant("mark", cat="t")
    tr.counter("depth", {"q": 3})
    tr.complete("query", 100.0, 50.0, ticket=7, snapshot_version=2)
    for _ in range(4):            # overflow the bounded buffer
        tr.instant("spam")
    assert len(tr) == 4
    obj = tr.to_chrome()
    assert validate_chrome_trace(obj) == []
    assert obj["otherData"]["dropped_events"] > 0
    names = [e["name"] for e in obj["traceEvents"]]
    assert "process_name" in names  # metadata event survives overflow


def test_validate_chrome_trace_flags_malformed_events():
    assert validate_chrome_trace({}) != []
    assert validate_chrome_trace({"traceEvents": []}) != []
    bad = {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "ts": 0.0}]}
    assert any("dur" in p for p in validate_chrome_trace(bad))


# --------------------------------------------------------- frontend threading
class _FakeFrontend(QueryFrontend):
    """Front end with a host-only query batch — isolates the threading
    behavior of submit/flush/drain from any device work."""

    def _query_batch(self, q, plan=None):
        b, k = q.shape[0], self.scfg.topk
        ids = torch.arange(k, dtype=torch.int32).repeat(b, 1)
        return (torch.zeros((b, k)), ids, ids,
                torch.zeros((b, k), dtype=torch.int32))


def test_frontend_totals_exact_under_concurrent_submit_flush():
    obs.enable()  # metrics recording must not perturb exactness
    cfg = small_cfg()
    fe = _FakeFrontend(cfg, ServerConfig(max_batch=8, max_wait_ms=0.0,
                                         topk=4, latency_window=64))
    n_submitters, per_thread = 4, 200
    answered: list[dict] = []
    alock = threading.Lock()
    stop = threading.Event()

    def submitter(seed):
        rng = np.random.default_rng(seed)
        for _ in range(per_thread):
            fe.submit(rng.normal(size=DIM).astype(np.float32))

    def flusher():
        while not stop.is_set():
            outs = fe.flush()
            if outs:
                with alock:
                    answered.extend(outs)

    flushers = [threading.Thread(target=flusher) for _ in range(2)]
    subs = [threading.Thread(target=submitter, args=(s,))
            for s in range(n_submitters)]
    for t in flushers + subs:
        t.start()
    for t in subs:
        t.join()
    stop.set()
    for t in flushers:
        t.join()
    answered.extend(fe.drain())

    total = n_submitters * per_thread
    tickets = sorted(a["ticket"] for a in answered)
    assert tickets == list(range(total))       # exactly once, no drops
    assert fe.stats["queries"] == total        # no lost increments
    assert sum(1 for _ in answered) == total
    lat = fe.latency_stats()
    assert lat["batches"] == fe.stats["batches"]
    assert lat["answer_window"] == min(total, 64)
    assert lat["window"] == min(lat["batches"], 64)
    assert lat["answer_p99_ms"] >= lat["answer_p90_ms"] >= \
        lat["answer_p50_ms"] >= 0.0
    reg = obs.metrics()
    assert reg.counter("serve_queries_total").value == total


def test_latency_stats_has_per_query_window_keys_when_empty():
    fe = _FakeFrontend(small_cfg(), ServerConfig(max_batch=4, topk=2))
    lat = fe.latency_stats()
    for key in ("p90_ms", "window", "answer_p50_ms", "answer_p90_ms",
                "answer_p99_ms", "answer_window"):
        assert key in lat
    assert lat["answer_window"] == 0 and lat["answer_p90_ms"] == 0.0


# ------------------------------------------------------- serving integration
class _CountingEngine(Engine):
    """Engine counting device_counters fetches — the probe behind the
    "device counters at publish only, never per query" property."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.counter_fetches = 0

    def device_counters(self):
        self.counter_fetches += 1
        return super().device_counters()


def _drive_async(server, stream, rounds=6, qps=4):
    for _ in range(rounds):
        b = stream.next_batch(16)
        for q in stream.queries(qps)["embedding"]:
            server.submit(q)
        server.serve_round(b)
    server.sync()
    server.drain()


def test_device_counters_fetched_at_publish_only():
    cfg = small_cfg(store_depth=4, update_interval=32)
    stream = make_stream("iot", dim=DIM)
    engine = _CountingEngine(cfg, 0, device="cpu")
    scfg = ServerConfig(max_batch=8, max_wait_ms=0.0, topk=5,
                        two_stage=True, nprobe=4)

    # disabled: the query path AND the publish path never fetch
    server = AsyncServer(cfg, scfg, engine=engine, publish_every=2)
    _drive_async(server, stream)
    server.close()
    assert engine.counter_fetches == 0
    assert obs.metrics() is None and obs.tracer() is None

    # enabled: fetched once per publish, still never per query batch
    obs.enable()
    engine2 = _CountingEngine(cfg, 1, device="cpu")
    server2 = AsyncServer(cfg, scfg, engine=engine2, publish_every=2)
    publishes_before = engine2.counter_fetches
    n_flushes = 0
    for _ in range(8):
        for q in stream.queries(4)["embedding"]:
            server2.submit(q)
        n_flushes += 1
        server2.flush()          # query path: must not fetch counters
    assert engine2.counter_fetches == publishes_before
    server2.ingest(stream.next_batch(16)["embedding"],
                   stream.next_batch(16)["doc_id"])
    server2.sync()               # forces a publish -> exactly one fetch
    assert engine2.counter_fetches > publishes_before
    server2.close()
    reg = obs.metrics()
    snap = reg.snapshot()
    assert snap["gauges"]["pipeline_arrivals"] > 0
    assert 0.0 <= snap["gauges"]["pipeline_admit_rate"] <= 1.0
    assert snap["counters"]["publish_total"] >= 1


def test_engine_device_counters_are_consistent():
    cfg = small_cfg(store_depth=4)
    eng = Engine(cfg, 0, device="cpu")
    stream = make_stream("iot", dim=DIM)
    b = stream.next_batch(48)
    eng.ingest(b["embedding"], b["doc_id"])
    c = eng.device_counters()
    assert c["arrivals"] == 48
    assert 0 <= c["admitted"] <= c["arrivals"]
    assert c["store_live"] <= c["store_slots"]
    assert 0.0 <= c["admit_rate"] <= 1.0
    assert 0.0 <= c["store_fill"] <= 1.0
    assert c["store_min_fill"] <= c["store_max_fill"] <= cfg.store_depth
    assert c["hh_occupied"] <= c["hh_capacity"]


def test_freshness_stats_snapshot_age_and_guard():
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    server = AsyncServer(cfg, ServerConfig(max_batch=4, topk=5,
                                           two_stage=True, nprobe=4),
                         seed=0, device="cpu", publish_every=1)
    server.ingest(stream.next_batch(16)["embedding"],
                  stream.next_batch(16)["doc_id"])
    server.sync()
    fresh = server.freshness_stats()
    assert fresh["published_at"] is not None
    assert 0.0 <= fresh["snapshot_age_s"] < 300.0  # sane wall-clock age
    # never-published snapshots (published_at == 0.0) report None, not a
    # bogus huge age
    server._published = server._published._replace(
        snap=server._snapshot._replace(published_at=0.0))
    fresh = server.freshness_stats()
    assert fresh["snapshot_age_s"] is None
    assert fresh["published_at"] is None
    server.close()


def test_async_trace_spans_correlate_with_published_versions():
    obs.enable()
    cfg = small_cfg(store_depth=4, update_interval=32)
    stream = make_stream("iot", dim=DIM)
    server = AsyncServer(cfg, ServerConfig(max_batch=8, max_wait_ms=0.0,
                                           topk=5, two_stage=True, nprobe=4),
                         seed=0, device="cpu", publish_every=2)
    _drive_async(server, stream, rounds=8, qps=4)
    server.close()

    tr = obs.tracer()
    obj = tr.to_chrome()
    assert validate_chrome_trace(obj) == []
    events = tr.events()
    published = {e["args"]["version"] for e in events
                 if e["name"] == "ingest.publish"}
    queries = [e for e in events if e["name"] == "query"]
    assert queries, "no per-query spans recorded"
    for q in queries:
        assert q["ph"] == "X" and q["dur"] >= 0.0
        assert "ticket" in q["args"]
        # every answer was served from a snapshot that was either the
        # constructor's initial publish (v1) or traced as published
        assert q["args"]["snapshot_version"] in published | {1}
    flushes = [e for e in events if e["name"] == "flush"]
    assert flushes and all("snapshot_version" in f["args"] for f in flushes)


def test_disabled_obs_records_nothing_and_answers_identically():
    cfg = small_cfg(store_depth=4, update_interval=32)
    scfg = ServerConfig(max_batch=8, max_wait_ms=0.0, topk=5,
                        two_stage=True, nprobe=4)

    def run():
        stream = make_stream("iot", dim=DIM)
        server = AsyncServer(cfg, scfg, seed=0, device="cpu",
                             publish_every=10**9)  # no mid-run publishes
        outs = []
        for _ in range(4):
            b = stream.next_batch(16)
            for q in stream.queries(4)["embedding"]:
                server.submit(q)
            outs += server.serve_round(b)
        server.sync()
        outs += server.drain()
        server.close()
        return sorted(outs, key=lambda o: o["ticket"])

    off = run()
    obs.enable()
    on = run()
    assert obs.metrics() is not None and len(obs.tracer()) > 0
    assert len(on) == len(off)
    for a, b in zip(on, off):               # retrieval gap exactly zero
        assert a["ticket"] == b["ticket"]
        np.testing.assert_array_equal(a["doc_ids"], b["doc_ids"])
        np.testing.assert_array_equal(a["scores"], b["scores"])


# ------------------------------------------------ names against the JAX one
def _named_run(pkg: str, tmp: str) -> tuple[set, set]:
    """A cached, durable async run with an embedder, then recovery from
    its directories, in ``pkg`` ("repro" or "repro_torch") with obs on:
    (metric names, span names)."""
    import importlib

    import jax

    o = importlib.import_module(f"{pkg}.obs")
    rt = importlib.import_module(f"{pkg}.serve.runtime")
    dur = importlib.import_module(f"{pkg}.serve.durability")
    conf = importlib.import_module(f"{pkg}.configs.streaming_rag")
    eng_mod = importlib.import_module(f"{pkg}.engine.engine")
    streams = importlib.import_module(f"{pkg}.data.streams")
    cfg = conf.paper_pipeline_config(dim=DIM, k=16, capacity=16, alpha=0.1,
                                     admit_prob=1.0, update_interval=32,
                                     store_depth=4)

    def engine():
        if pkg == "repro":
            return eng_mod.Engine(cfg, jax.random.key(0))
        return eng_mod.Engine(cfg, 0, device="cpu")

    scfg = rt.ServerConfig(max_batch=8, max_wait_ms=0.0, topk=4,
                           two_stage=True, nprobe=2, cache_entries=32,
                           hotset=True, pin_budget_mb=1.0, hotset_refresh=1,
                           hotset_min_count=1)
    dcfg = dur.DurabilityConfig(checkpoint_dir=tmp, checkpoint_every=2)
    stream = streams.make_stream("iot", dim=DIM)
    pool = np.asarray(stream.queries(4)["embedding"], np.float32)
    o.disable()
    o.enable()
    try:
        srv = rt.AsyncServer(cfg, scfg, engine=engine(), publish_every=2,
                             durability=dcfg, embed_fn=np.stack)
        for _ in range(4):
            b = stream.next_batch(16)
            srv.ingest(b["embedding"], b["doc_id"])
            srv.sync(timeout=60.0)
            for qv in pool[[0, 1, 0, 2]]:
                srv.submit(qv)
            srv.drain()
        srv.close()
        b = stream.next_batch(16)
        dur_again = dur.DurableIngest(dcfg)   # journal one more batch
        dur_again.record(np.asarray(b["embedding"]), np.asarray(b["doc_id"]))
        dur_again.close()
        srv2 = rt.AsyncServer(cfg, scfg, engine=engine(), publish_every=2,
                              durability=dcfg)
        assert srv2.recovery_report["replayed"] == 1
        srv2.close()
        snap = o.metrics().snapshot()
        metrics = set(snap["counters"]) | set(snap["gauges"]) \
            | set(snap["histograms"])
        spans = {e["name"] for e in o.tracer().events()}
    finally:
        o.disable()
    return metrics, spans


def test_instrument_and_span_names_match_reference(tmp_path):
    want_m, want_s = _named_run("repro", str(tmp_path / "jax"))
    got_m, got_s = _named_run("repro_torch", str(tmp_path / "torch"))
    # jit-trace counters have no counterpart: the port traces nothing
    want_m = {m for m in want_m if not m.startswith("kernel_traces_total_")}
    assert got_m == want_m, (got_m ^ want_m)
    assert got_s == want_s, (got_s ^ want_s)
    for name in ("serve_batch_latency_ms", "publish_latency_ms",
                 "cache_hits_total", "hotset_pinned_bytes",
                 "journal_appends_total", "checkpoint_bytes_last",
                 "recovery_replayed_total"):
        assert name in got_m, name
    assert {"flush", "embed", "query", "ingest.enqueue", "ingest.admit",
            "ingest.publish", "recovery", "recovery.replay"} <= got_s


# ---------------------------------------------------------------- obs.kern
def test_kern_profile_records_wall_time_and_modeled_cost_waits():
    obs.enable(trace=False)
    x = torch.randn(64, 64)
    out = kern.profile_kernel("matmul", lambda: x @ x, reps=3, rounds=2)
    assert out["wall_us"] > 0.0
    assert "kernels" not in out     # host tensors: nothing launched on a card
    snap = obs.metrics().snapshot()["gauges"]
    assert snap["kernel_matmul_wall_us"] == out["wall_us"]
    assert kern.time_wall(lambda: x @ x, reps=2, rounds=1) > 0.0
    # the modeled cost (analysis/hlo_cost.py): 2 * 64^3 flops, two inputs
    # and the result of 64 x 64 f32 each
    modeled = {"modeled_hbm_bytes": 3 * 64 * 64 * 4.0, "modeled_flops": 2 * 64.0 ** 3,
               "modeled_collective_bytes": 0.0}
    assert kern.modeled_cost(lambda: x @ x) == modeled
    assert {k: out[k] for k in modeled} == modeled
    assert snap["kernel_matmul_modeled_flops"] == modeled["modeled_flops"]
    assert set(kern.profile_kernel("matmul", lambda: x @ x, time_it=False)) == set(modeled)
