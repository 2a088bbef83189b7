"""The port's ``AsyncServer`` (background ingest, snapshot publishes, the
plan ladder in the front end) on the CPU: against the JAX package's
``AsyncServer`` on the same inputs, and the reference's own runtime
invariants (``tests/test_async_runtime.py``) on the port.

* parity: both servers start from one state (``convert``), ingest the same
  batches (the port fed the reference's heavy-hitter draws, taken after
  each ``sync``) and answer the same queries: tickets and
  ``snapshot_version`` equal, ids and clusters exact, scores within rtol
  1e-5 (the two packages sum in other orders);
* threaded stress: concurrent background ingest and foreground queries —
  every ticket answered exactly once, every answer reproducible from the
  published snapshot it names;
* adaptive overload: a flood walks the degradation ladder down to
  shedding and back, every ticket answered once with honest markers;
* error surfacing, supervision (restarts, quarantine), drain racing
  submits, monotone tickets, inert dead rows.

Every wait has a bound: ``sync``/``close`` take timeouts, every join is
bounded and followed by an ``is_alive`` check.
"""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.streaming_rag import paper_pipeline_config as j_config
from repro.core import pipeline as jpipe
from repro.engine.engine import Engine as JEngine
from repro.serve.runtime import AsyncServer as JAsyncServer
from repro.serve.runtime import ServerConfig as JServerConfig
from repro_torch import convert
from repro_torch.configs.streaming_rag import paper_pipeline_config as t_config
from repro_torch.core import clustering, heavy_hitter, pipeline, prefilter
from repro_torch.data.streams import make_stream
from repro_torch.engine.engine import Engine
from repro_torch.engine.plan import QueryPlan
from repro_torch.serve.runtime import AsyncServer, ServerConfig
from repro_torch.serve.server import RAGServer

from _torch_parity import ingest_draws, jax_tree

DIM = 32
T = 60.0   # seconds any one wait may take

pytestmark = pytest.mark.timeout(300)


def small_cfg(**kw):
    return pipeline.PipelineConfig(
        pre=prefilter.PrefilterConfig(num_vectors=3, dim=DIM, alpha=0.0,
                                      basis="fixed"),
        clus=clustering.ClusterConfig(num_clusters=16, dim=DIM),
        hh=heavy_hitter.HHConfig(capacity=8, admit_prob=0.5),
        update_interval=kw.pop("update_interval", 64),
        **kw)


class _RecordingEngine(Engine):
    """Keeps every published snapshot, so answers can be re-verified
    against the exact snapshot they were served from."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.published = {}

    def publish(self):
        snap = super().publish()
        self.published[snap.version] = snap
        return snap


def _join(threads):
    for t in threads:
        t.join(T)
    assert not any(t.is_alive() for t in threads)


def _same_answer(engine, a, q, plan=None, nprobe=4):
    snap = engine.published[a["snapshot_version"]]
    want = engine.query_snapshot(snap, q[None], 5, two_stage=True,
                                 nprobe=nprobe, plan=plan)
    np.testing.assert_array_equal(a["doc_ids"], want[2][0].numpy())
    np.testing.assert_array_equal(a["scores"], want[0][0].numpy())


# ------------------------------------------------------- against the JAX one
PKW = dict(dim=DIM, k=16, capacity=16, store_depth=4, update_interval=100,
           alpha=0.05, admit_prob=0.5)


@pytest.mark.parametrize("adaptive", [False, True])
def test_async_server_matches_reference(adaptive):
    B, Q = 48, 7
    jc, tc = j_config(store_dtype="int8", **PKW), t_config(store_dtype="int8", **PKW)
    rng = np.random.default_rng(11)
    warm = rng.normal(size=(64, DIM)).astype(np.float32)
    js = jpipe.init(jc, jax.random.key(11), jnp.asarray(warm))
    jeng = JEngine(jc, jax.random.key(11), state=js)
    teng = Engine(tc, state=convert.state_from_numpy(jax_tree(js), "cpu"))
    # adaptive: a low watermark the per-round backlog crosses, so plans move
    sc = dict(max_batch=2, max_wait_ms=0.0, topk=5, two_stage=True, nprobe=4,
              adaptive=adaptive, max_queue_depth=2, low_queue_depth=0,
              recover_after=1)
    jsrv = JAsyncServer(jc, JServerConfig(**sc), engine=jeng, publish_every=2,
                        queue_max=4)
    tsrv = AsyncServer(tc, ServerConfig(**sc), engine=teng, publish_every=2,
                       queue_max=4)
    jans, tans = [], []
    try:
        for step in range(6):
            x = rng.normal(size=(B, DIM)).astype(np.float32)
            ids = np.arange(step * B, (step + 1) * B, dtype=np.int32)
            if step % 2:
                ids[-5:] = -1          # dead padding rows
            draws = ingest_draws(jeng.state, B, jc.hh.bmax())
            jsrv.ingest(x, ids)
            tsrv.ingest(x, ids, draws=draws)
            jsrv.sync(timeout=T)
            tsrv.sync(timeout=T)
            for qv in rng.normal(size=(Q, DIM)).astype(np.float32):
                assert jsrv.submit(qv) == tsrv.submit(qv)
            jans += jsrv.drain()
            tans += tsrv.drain()
        assert tsrv.freshness_stats()["lag_docs"] == 0
        for name in ("freshness_stats", "robustness_stats", "latency_stats"):
            j, t = getattr(jsrv, name)(), getattr(tsrv, name)()
            assert set(t) == set(j), name
        jf, tf = jsrv.freshness_stats(), tsrv.freshness_stats()
        for key in ("snapshot_version", "docs_enqueued", "docs_ingested",
                    "docs_published", "lag_docs"):
            assert tf[key] == jf[key], key
        assert tsrv.robustness_stats() == jsrv.robustness_stats()
        assert tsrv.state_memory_bytes() == jsrv.state_memory_bytes()
        assert teng.store_bytes_per_device() == jeng.store_bytes_per_device()
    finally:
        jsrv.close(timeout=T)
        tsrv.close(timeout=T)
    assert [a["ticket"] for a in tans] == [a["ticket"] for a in jans] \
        == list(range(6 * Q))
    for ja, ta in zip(jans, tans):
        for key in ("snapshot_version", "degraded", "shed", "plan"):
            assert ta[key] == ja[key], key
        np.testing.assert_array_equal(ta["doc_ids"], np.asarray(ja["doc_ids"]))
        np.testing.assert_array_equal(ta["clusters"], np.asarray(ja["clusters"]))
        np.testing.assert_allclose(ta["scores"], np.asarray(ja["scores"]),
                                   rtol=1e-5, atol=1e-6)
    assert len({a["snapshot_version"] for a in tans}) == 6
    if adaptive:
        assert any(a["degraded"] for a in tans) and tsrv.stats["shed"] > 0
        assert tsrv.stats["shed"] == jsrv.stats["shed"]


# ------------------------------------------- the reference's invariants, ported
def test_async_stress_exactly_once_from_published_snapshots():
    cfg = small_cfg(store_depth=4, update_interval=32)
    stream = make_stream("iot", dim=DIM)
    engine = _RecordingEngine(cfg, 0, device="cpu")
    server = AsyncServer(
        cfg, ServerConfig(max_batch=8, max_wait_ms=0.0, topk=5,
                          two_stage=True, nprobe=4),
        engine=engine, publish_every=2, queue_max=4)

    n_rounds, qps = 12, 6
    queries: dict[int, np.ndarray] = {}
    qlock = threading.Lock()

    def submitter():
        for _ in range(n_rounds):
            for qv in stream.queries(qps)["embedding"]:
                t = server.submit(qv)
                with qlock:
                    queries[t] = np.asarray(qv)

    sub = threading.Thread(target=submitter)
    sub.start()
    answers = []
    for _ in range(n_rounds):
        answers += server.serve_round(stream.next_batch(32))  # flush, then enqueue
    _join([sub])
    server.sync(timeout=T)
    answers += server.drain()
    server.close(timeout=T)

    tickets = [a["ticket"] for a in answers]
    assert len(tickets) == len(queries) == n_rounds * qps
    assert sorted(tickets) == sorted(queries)
    versions = {a["snapshot_version"] for a in answers}
    assert versions <= set(engine.published)
    assert len(engine.published) >= 2
    for a in answers[:: max(1, len(answers) // 16)]:
        _same_answer(engine, a, queries[a["ticket"]])
    fresh = server.freshness_stats()
    assert fresh["docs_ingested"] == fresh["docs_published"]
    assert fresh["lag_docs"] == 0


def test_async_adaptive_overload_sheds_exactly_once_with_markers():
    cfg = small_cfg(store_depth=4, update_interval=32)
    stream = make_stream("iot", dim=DIM)
    engine = _RecordingEngine(cfg, 0, device="cpu")
    scfg = ServerConfig(max_batch=4, max_wait_ms=0.0, topk=5, two_stage=True,
                        nprobe=4, adaptive=True, max_queue_depth=6,
                        low_queue_depth=0, recover_after=2)
    server = AsyncServer(cfg, scfg, engine=engine, publish_every=2, queue_max=4)
    assert len(server.plan_space.ladder) == 3   # full -> (4, 2) -> shed
    full = server.plan_space.full
    for _ in range(4):
        server.ingest(stream.next_batch(32)["embedding"],
                      stream.next_batch(32)["doc_id"])
    server.sync(timeout=T)

    n_burst = 60
    queries: dict[int, np.ndarray] = {}
    qlock = threading.Lock()

    def flooder():
        for qv in stream.queries(n_burst)["embedding"]:
            t = server.submit(qv)
            with qlock:
                queries[t] = np.asarray(qv)

    sub = threading.Thread(target=flooder)
    sub.start()
    deadline = time.monotonic() + T
    while len(server._pending) < scfg.max_queue_depth + scfg.max_batch:
        assert time.monotonic() < deadline, "the backlog never built"
        time.sleep(0.001)
    answers = []
    while len(answers) < n_burst:
        assert time.monotonic() < deadline, "the flood was never answered"
        answers += server.flush()
        if len(answers) % 12 == 0:  # concurrent ingest
            server.ingest(stream.next_batch(16)["embedding"],
                          stream.next_batch(16)["doc_id"])
    _join([sub])
    for qv in stream.queries(10)["embedding"]:   # calm: recover to full
        t = server.submit(qv)
        with qlock:
            queries[t] = np.asarray(qv)
        answers += server.flush()
    server.sync(timeout=T)
    answers += server.drain()
    server.close(timeout=T)

    tickets = [a["ticket"] for a in answers]
    assert sorted(tickets) == sorted(queries)
    assert len(tickets) == len(set(tickets)) == n_burst + 10
    shed = [a for a in answers if a["shed"]]
    degraded_live = [a for a in answers if a["degraded"] and not a["shed"]]
    full_effort = [a for a in answers if not a["degraded"]]
    assert shed and degraded_live and full_effort
    assert server.stats["shed"] == len(shed)
    assert answers[-1]["degraded"] is False
    for a in shed:
        assert a["degraded"] is True and "snapshot_version" in a
        assert np.all(a["doc_ids"] == -1) and np.all(a["clusters"] == -1)
        assert np.all(np.isneginf(a["scores"]))
    for a in degraded_live:
        assert QueryPlan(a["plan"]["nprobe"], a["plan"]["depth"]) != full
    live = [a for a in answers if not a["shed"]]
    for a in live[:: max(1, len(live) // 12)]:
        plan = QueryPlan(a["plan"]["nprobe"], a["plan"]["depth"])
        _same_answer(engine, a, queries[a["ticket"]], plan=plan)


def test_async_ingest_thread_error_surfaces():
    cfg = small_cfg(store_depth=4)
    server = AsyncServer(
        cfg, ServerConfig(max_batch=4, topk=5, two_stage=True, nprobe=4),
        seed=1, device="cpu", publish_every=1, queue_max=2)
    server.ingest(np.zeros((8, DIM + 1), np.float32),  # wrong dim -> dies
                  np.arange(8, dtype=np.int32))
    with pytest.raises((RuntimeError, TimeoutError)):
        server.sync(timeout=10.0)
        server.ingest(np.zeros((8, DIM), np.float32),
                      np.arange(8, dtype=np.int32))
        server.sync(timeout=10.0)
    with pytest.raises(RuntimeError, match="batch seq 0"):
        server.submit(np.zeros(DIM, np.float32))
    assert server.robustness_stats()["error_seq"] == 0
    assert server.robustness_stats()["restarts"] == 0   # fatal: no retry


class _FlakyEngine(Engine):
    """Raises a transient error on chosen ingest attempts (by call count)."""

    def __init__(self, *a, fail_calls=(), **kw):
        super().__init__(*a, **kw)
        self.calls, self.fail_calls = 0, set(fail_calls)

    def ingest(self, x, doc_ids, draws=None):
        self.calls += 1
        if self.calls in self.fail_calls:
            raise TimeoutError("transient")
        return super().ingest(x, doc_ids, draws)


def test_async_supervisor_restarts_and_quarantines():
    """A transient failure restarts the loop and retries the batch; a
    batch that fails its admission 3 times is quarantined and the stream
    goes on; the schema of robustness_stats stays the reference's."""
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    # call 1 ok (seq 0); call 2 fails once, call 3 retries seq 1; calls
    # 4-6 fail seq 2 three times (quarantine); call 7 takes seq 3
    engine = _FlakyEngine(cfg, 0, device="cpu", fail_calls={2, 4, 5, 6})
    server = AsyncServer(cfg, ServerConfig(max_batch=4, topk=5), engine=engine,
                         publish_every=1, backoff_base_s=0.001,
                         backoff_max_s=0.002)
    for _ in range(4):
        b = stream.next_batch(16)
        server.ingest(b["embedding"], b["doc_id"])
    server.sync(timeout=T)
    rs = server.robustness_stats()
    server.close(timeout=T)
    assert rs["restarts"] == 4 and rs["quarantined"] == [2]
    assert rs["error_seq"] is None and rs["durable"] is False
    assert server.freshness_stats()["docs_ingested"] == 3 * 16


def test_tickets_monotone_and_drain_answers_everything():
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    server = RAGServer(cfg, ServerConfig(max_batch=4, max_wait_ms=0.0,
                                         topk=5, two_stage=True, nprobe=4),
                       seed=2, device="cpu")
    server.ingest(stream.next_batch(64)["embedding"],
                  stream.next_batch(64)["doc_id"])
    first = [server.submit(q) for q in stream.queries(10)["embedding"]]
    assert first == list(range(10))
    out1 = server.flush()
    assert [o["ticket"] for o in out1] == [0, 1, 2, 3]
    rest = server.drain()
    assert [o["ticket"] for o in rest] == [4, 5, 6, 7, 8, 9]
    assert not server._pending
    more = [server.submit(q) for q in stream.queries(3)["embedding"]]
    assert more == [10, 11, 12]
    out2 = server.drain()
    assert [o["ticket"] for o in out2] == [10, 11, 12]
    seen = [o["ticket"] for o in out1 + rest + out2]
    assert len(seen) == len(set(seen)) == 13
    assert all(o["plan"] == {"nprobe": 4, "depth": 4} and o["degraded"] is False
               for o in out1 + rest + out2)


def test_dead_rows_are_inert_for_retrieval_state():
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    b = stream.next_batch(30)
    x, ids = b["embedding"], np.asarray(b["doc_id"], np.int32)
    xp = np.concatenate([x, np.zeros((2, DIM), np.float32)])
    idp = np.concatenate([ids, np.full((2,), -1, np.int32)])
    draws = heavy_hitter.draw(cfg.hh, 32, torch.Generator().manual_seed(3), "cpu")
    cut = {k: v[:30] for k, v in draws.items()}
    s_plain, _ = pipeline.ingest_batch(cfg, pipeline.init(cfg, 3, device="cpu"),
                                       x, ids, cut)
    s_pad, info = pipeline.ingest_batch(cfg, pipeline.init(cfg, 3, device="cpu"),
                                        xp, idp, draws)
    assert torch.equal(s_plain.clus.counts, s_pad.clus.counts)
    assert torch.equal(s_plain.clus.centroids, s_pad.clus.centroids)
    for name in ("ids", "stamps", "ptr", "embs"):
        assert torch.equal(getattr(s_plain.store, name), getattr(s_pad.store, name))
    assert s_pad.arrivals == s_plain.arrivals == 30
    assert int(s_pad.kept) == int(s_plain.kept)
    assert int(s_pad.hh.total_seen) == int(s_plain.hh.total_seen)
    assert not bool(info["keep"][-2:].any())


def test_drain_racing_concurrent_submit_answers_exactly_once():
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    server = AsyncServer(
        cfg, ServerConfig(max_batch=4, max_wait_ms=0.0, topk=5,
                          two_stage=True, nprobe=4),
        seed=3, device="cpu", publish_every=2, queue_max=4)
    server.ingest(stream.next_batch(64)["embedding"],
                  stream.next_batch(64)["doc_id"])
    server.sync(timeout=T)
    batches = [stream.queries(30)["embedding"] for _ in range(3)]
    tickets: list[int] = []
    tlock = threading.Lock()

    def submitter(seed: int):
        rng = np.random.default_rng(seed)
        for qv in batches[seed]:
            t = server.submit(qv)
            with tlock:
                tickets.append(t)
            if rng.random() < 0.2:
                time.sleep(0.0005)

    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(3)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        answers = []
        deadline = time.monotonic() + T
        while any(th.is_alive() for th in threads):
            assert time.monotonic() < deadline
            answers += server.drain()
        _join(threads)
    finally:
        sys.setswitchinterval(switch)
    answers += server.drain()
    got = sorted(a["ticket"] for a in answers)
    assert got == sorted(tickets)
    assert len(got) == len(set(got)) == 90
    assert not server._pending
    server.close(timeout=T)


def test_unported_runtime_options_raise(tmp_path):
    """Every runtime option is ported now; what remains are the guards:
    caching and adaptive serving need two_stage. Durability constructs
    and journals."""
    from repro_torch.serve.durability import DurabilityConfig

    cfg = small_cfg(store_depth=4)
    srv = AsyncServer(cfg, ServerConfig(topk=4, two_stage=True, nprobe=2),
                      seed=0, device="cpu",
                      durability=DurabilityConfig(checkpoint_dir=str(tmp_path)))
    srv.ingest(np.zeros((4, DIM), np.float32), np.arange(4, dtype=np.int32))
    srv.close(timeout=T)
    assert srv.robustness_stats()["durable"]
    assert srv.robustness_stats()["journal_last_seq"] == 0
    for opt in ({"adaptive": True}, {"cache_entries": 8}, {"hotset": True}):
        with pytest.raises(AssertionError, match="two_stage"):
            AsyncServer(cfg, ServerConfig(topk=4, **opt), seed=0, device="cpu")
