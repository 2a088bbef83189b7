"""The port's fault-injection suite (``tests/test_faults.py`` on
``repro_torch``): every named fault point, exact counters.

For each point in ``repro_torch.testing.faults.POINTS`` the suite asserts the
two supervision contracts from the robustness story:

  (a) queries keep answering from the pinned snapshot while the fault is
      live — no flush blocks, no shed required;
  (b) the supervisor recovers (bounded restarts, exponential backoff) or
      quarantines (poison batches, after the per-batch retry budget)
      with EXACT counters — and the resulting engine state is
      bit-identical to the fault-free run wherever the contract promises
      it (retried batches apply exactly once).

The same machinery drives CI and benchmarks through the ``REPRO_FAULTS``
env var; the subprocess test pins that path too.
"""
import faulthandler
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from repro_torch.core import clustering, heavy_hitter, pipeline, prefilter
from repro_torch.data.streams import make_stream
from repro_torch.engine.engine import Engine
from repro_torch.serve.durability import DurabilityConfig
from repro_torch.serve.runtime import AsyncServer, ServerConfig
from repro_torch.testing import faults
from repro_torch.train import checkpoint as ckpt_lib

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


def small_cfg(**kw):
    return pipeline.PipelineConfig(
        pre=prefilter.PrefilterConfig(num_vectors=3, dim=DIM, alpha=0.0,
                                      basis="fixed"),
        clus=clustering.ClusterConfig(num_clusters=16, dim=DIM),
        hh=heavy_hitter.HHConfig(capacity=8, admit_prob=0.5),
        update_interval=kw.pop("update_interval", 64),
        **kw)


def scfg(**kw):
    return ServerConfig(max_batch=8, topk=5, two_stage=True, nprobe=4, **kw)


def assert_leaves_identical(a, b):
    fa, fb = ckpt_lib.flatten_tree(a), ckpt_lib.flatten_tree(b)
    assert fa.keys() == fb.keys()
    bad = [k for k in fa if not np.array_equal(ckpt_lib.to_host(fa[k]),
                                               ckpt_lib.to_host(fb[k]))]
    assert not bad, f"leaves differ: {bad}"


def new_engine(cfg):
    return Engine(cfg, 0, device="cpu")


def _reference_engine(cfg, batches, skip=()):
    ref = new_engine(cfg)
    for i, b in enumerate(batches):
        if i not in skip:
            ref.ingest(b["embedding"], b["doc_id"])
    return ref


# ------------------------------------------------------------ harness itself
def test_fault_spec_parse():
    s = faults.FaultSpec.parse("ingest.admit:raise@3x2")
    assert (s.point, s.mode, s.at, s.count) == ("ingest.admit", "raise", 3, 2)
    assert [s.fires(h) for h in (1, 2, 3, 4, 5)] == \
        [False, False, True, True, False]
    s = faults.FaultSpec.parse("publish:stall")
    assert (s.point, s.mode, s.at, s.count) == ("publish", "stall", 1, 1)
    every = faults.FaultSpec.parse("replay:crash@2x0")  # 0 = every hit >= at
    assert every.fires(2) and every.fires(99) and not every.fires(1)
    with pytest.raises(AssertionError):
        faults.FaultSpec.parse("replay:explode")


def test_inject_rejects_nesting_and_counts_hits():
    with faults.inject("publish:raise@2") as plan:
        with pytest.raises(AssertionError):
            with faults.inject("publish:raise@1"):
                pass
        faults.fault_point("publish")            # hit 1: armed, no fire
        with pytest.raises(faults.InjectedFault):
            faults.fault_point("publish")        # hit 2: fires
        assert plan.hits("publish") == 2
        assert plan.fired("publish") == 1
    faults.fault_point("publish")  # disarmed again: free no-op


# ---------------------------------------------------- point: ingest.admit
def test_admit_transient_fault_recovers_exactly_once():
    """Transient admit failures are retried by the supervisor; the batch
    applies EXACTLY once — final state bit-identical to the no-fault run
    — and the restart counter is exact."""
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    batches = [stream.next_batch(16) for _ in range(6)]
    ref = _reference_engine(cfg, batches)

    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                      publish_every=2, backoff_base_s=0.001)
    with faults.inject("ingest.admit:raise@3x2") as plan:
        for b in batches:
            srv.ingest(b["embedding"], b["doc_id"])
        srv.sync(timeout=60.0)
        # hits 3 and 4 fired: batch seq 2 failed twice, then applied
        assert plan.fired("ingest.admit") == 2
    assert srv.restarts == 2
    assert srv.quarantined == []
    assert_leaves_identical(ref.state, srv.engine.state)
    srv.close()


def test_admit_poison_batch_quarantined_with_exact_counters():
    """A batch that burns its whole per-batch retry budget is quarantined
    — counted and named, never silently dropped, never retried forever —
    and the rest of the stream still applies (state == reference that
    skipped the poison batch)."""
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    batches = [stream.next_batch(16) for _ in range(6)]
    ref = _reference_engine(cfg, batches, skip={2})

    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                      publish_every=2, backoff_base_s=0.001)
    # batch seq 2 fails on every attempt of its retry budget (hits 3..5)
    with faults.inject("ingest.admit:raise@3x3") as plan:
        for b in batches:
            srv.ingest(b["embedding"], b["doc_id"])
        srv.sync(timeout=60.0)
        assert plan.fired("ingest.admit") == 3
    assert srv.restarts == 3
    assert srv.quarantined == [2]
    assert srv.robustness_stats()["quarantined"] == [2]
    assert_leaves_identical(ref.state, srv.engine.state)
    srv.close()


def test_admit_fatal_fault_surfaces_with_seq():
    """Fatal errors are NOT retried: they surface on the caller thread
    with the failing batch's sequence number — on submit() too."""
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                      publish_every=2)
    with faults.inject("ingest.admit:fatal@2"):
        srv.ingest(stream.next_batch(16)["embedding"],
                   stream.next_batch(16)["doc_id"])
        try:
            srv.ingest(stream.next_batch(16)["embedding"],
                       stream.next_batch(16)["doc_id"])
        except RuntimeError:
            pass  # thread may already be dead when the producer returns
        srv._thread.join(30.0)
    assert srv.restarts == 0            # fatal: zero retries
    with pytest.raises(RuntimeError, match=r"batch seq 1"):
        srv.submit(stream.queries(1)["embedding"][0])
    with pytest.raises(RuntimeError, match=r"batch seq 1"):
        srv.flush()
    with pytest.raises(RuntimeError):
        srv.close()


def test_queries_answer_from_pinned_snapshot_during_admit_stall():
    """(a) of the contract: a stalled ingest thread never blocks the
    query path — flushes answer from the pinned snapshot while the
    fault is live."""
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    srv = AsyncServer(cfg, scfg(max_wait_ms=0.0),
                      engine=new_engine(cfg),
                      publish_every=1)
    # warm the serve path (compile) before arming the fault
    srv.ingest(stream.next_batch(16)["embedding"],
               stream.next_batch(16)["doc_id"])
    srv.sync(timeout=60.0)
    for qv in stream.queries(4)["embedding"]:
        srv.submit(qv)
    assert len(srv.drain()) == 4

    spec = faults.FaultSpec("ingest.admit", mode="stall", at=1, count=0,
                            stall_s=1.5)
    with faults.inject(spec) as plan:
        srv.ingest(stream.next_batch(16)["embedding"],
                   stream.next_batch(16)["doc_id"])
        deadline = time.monotonic() + 10.0
        while plan.hits("ingest.admit") == 0:  # fault is live now
            assert time.monotonic() < deadline
            time.sleep(0.005)
        t0 = time.perf_counter()
        for qv in stream.queries(6)["embedding"]:
            srv.submit(qv)
        out = srv.drain()
        answered_in = time.perf_counter() - t0
        assert len(out) == 6
        assert all(not o.get("shed", False) for o in out)
        # answered while the admit stall was still sleeping
        assert answered_in < 1.0, f"queries stalled {answered_in:.2f}s"
    srv.sync(timeout=60.0)
    srv.close()


# --------------------------------------------------- point: ingest.enqueue
def test_enqueue_stall_blocks_producer_not_queries():
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    srv = AsyncServer(cfg, scfg(max_wait_ms=0.0),
                      engine=new_engine(cfg),
                      publish_every=1)
    srv.ingest(stream.next_batch(16)["embedding"],
               stream.next_batch(16)["doc_id"])
    srv.sync(timeout=60.0)
    for qv in stream.queries(2)["embedding"]:   # warm the serve path
        srv.submit(qv)
    srv.drain()

    spec = faults.FaultSpec("ingest.enqueue", mode="stall", at=1, count=0,
                            stall_s=0.4)
    stalled_batches = 4
    with faults.inject(spec) as plan:
        def producer():
            for _ in range(stalled_batches):
                srv.ingest(stream.next_batch(16)["embedding"],
                           stream.next_batch(16)["doc_id"])

        prod = threading.Thread(target=producer)
        prod.start()
        t0 = time.perf_counter()
        for qv in stream.queries(6)["embedding"]:
            srv.submit(qv)
        out = srv.drain()
        answered_in = time.perf_counter() - t0
        assert len(out) == 6
        # the producer was still wading through its stalls when the
        # queries came back — enqueue backpressure never touched them
        assert prod.is_alive() or answered_in < stalled_batches * 0.4
        prod.join(30.0)
        assert plan.fired("ingest.enqueue") == stalled_batches
    srv.sync(timeout=60.0)
    assert srv.freshness_stats()["lag_docs"] == 0
    srv.close()


# ---------------------------------------------------------- point: publish
def test_publish_fault_retried_and_queries_keep_answering():
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    batches = [stream.next_batch(16) for _ in range(4)]
    ref = _reference_engine(cfg, batches)

    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                      publish_every=2, backoff_base_s=0.001)
    with faults.inject("publish:raise@1") as plan:
        for b in batches:
            srv.ingest(b["embedding"], b["doc_id"])
        # queries during the faulted publish answer from the pinned
        # (construction-time) snapshot
        for qv in stream.queries(3)["embedding"]:
            srv.submit(qv)
        assert len(srv.drain()) == 3
        srv.sync(timeout=60.0)
        assert plan.fired("publish") == 1
    assert srv.restarts == 1
    assert_leaves_identical(ref.state, srv.engine.state)
    fresh = srv.freshness_stats()
    assert fresh["lag_docs"] == 0        # the retried publish landed
    assert fresh["snapshot_version"] >= 2
    srv.close()


# -------------------------------------------------- point: checkpoint.write
def test_checkpoint_write_fault_counted_and_covered(tmp_path):
    """An injected checkpoint-write failure is counted, never advances
    the dirty baseline, and the next cadence save covers everything —
    recovery is still bit-identical."""
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    batches = [stream.next_batch(16) for _ in range(8)]
    ref = _reference_engine(cfg, batches)

    dcfg = DurabilityConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                      publish_every=2, durability=dcfg)
    with faults.inject("checkpoint.write:raise@2") as plan:
        for b in batches:
            srv.ingest(b["embedding"], b["doc_id"])
        srv.sync(timeout=60.0)
        srv.close()
        assert plan.fired("checkpoint.write") == 1
    stats = srv.robustness_stats()
    assert stats["checkpoint_saves"]["failed"] == 1
    assert stats["checkpoint_saves"]["full"] >= 1
    assert srv.restarts == 0      # async write failure: not a restart

    srv2 = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                       publish_every=2, durability=dcfg)
    assert_leaves_identical(ref.state, srv2.engine.state)
    srv2.close()


# ----------------------------------------------------------- point: replay
def test_replay_transient_fault_quarantines_within_budget(tmp_path):
    """A transient fault that keeps firing on one replayed batch consumes
    the per-batch retry budget and quarantines exactly that batch — the
    rest of the journal tail still recovers."""
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    batches = [stream.next_batch(16) for _ in range(6)]

    dcfg = DurabilityConfig(checkpoint_dir=str(tmp_path),
                            checkpoint_every=100)  # journal-only recovery
    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                      publish_every=2, durability=dcfg)
    with faults.inject("ingest.admit:crash@6"):
        for b in batches:
            try:
                srv.ingest(b["embedding"], b["doc_id"])
            except RuntimeError:
                pass
        srv._thread.join(30.0)
    srv._durable.close()

    # batch seq 2 is poison on replay: hits 3,4,5 (its full retry budget)
    with faults.inject("replay:raise@3x3") as plan:
        srv2 = AsyncServer(cfg, scfg(),
                           engine=new_engine(cfg),
                           publish_every=2, durability=dcfg)
        assert plan.fired("replay") == 3
    rep = srv2.recovery_report
    assert rep["quarantined"] == [2]
    assert rep["replayed"] == len(batches) - 1
    ref = _reference_engine(cfg, batches, skip={2})
    assert_leaves_identical(ref.state, srv2.engine.state)
    # the quarantined seq is remembered: a LATER recovery skips it
    # outright instead of replaying a known poison batch
    assert 2 in srv2._durable.quarantined
    srv2.close()


# ------------------------------------------------------- REPRO_FAULTS env
def test_repro_faults_env_drives_the_same_machinery(tmp_path):
    """CI and benchmarks arm faults through the env var — same plan, same
    points, same counters as the context manager."""
    prog = textwrap.dedent("""
        import os
        os.environ["REPRO_FAULTS"] = "ingest.admit:crash@3"
        import sys
        import numpy as np
        from repro_torch.core import clustering, heavy_hitter, pipeline, prefilter
        from repro_torch.data.streams import make_stream
        from repro_torch.engine.engine import Engine
        from repro_torch.serve.durability import DurabilityConfig
        from repro_torch.serve.runtime import AsyncServer, ServerConfig
        from repro_torch.testing import faults
        from repro_torch.train import checkpoint as ckpt_lib

        DIM = 32
        cfg = pipeline.PipelineConfig(
            pre=prefilter.PrefilterConfig(num_vectors=3, dim=DIM, alpha=0.0,
                                          basis="fixed"),
            clus=clustering.ClusterConfig(num_clusters=16, dim=DIM),
            hh=heavy_hitter.HHConfig(capacity=8, admit_prob=0.5),
            update_interval=64, store_depth=4)
        scfg = ServerConfig(max_batch=8, topk=5, two_stage=True, nprobe=4)
        stream = make_stream("iot", dim=DIM)
        batches = [stream.next_batch(16) for _ in range(5)]
        ref = Engine(cfg, 0, device="cpu")
        for b in batches:
            ref.ingest(b["embedding"], b["doc_id"])

        dcfg = DurabilityConfig(checkpoint_dir="{d}", checkpoint_every=2)
        srv = AsyncServer(cfg, scfg, engine=Engine(cfg, 0, device="cpu"),
                          publish_every=2, durability=dcfg)
        for b in batches:
            try:
                srv.ingest(b["embedding"], b["doc_id"])
            except RuntimeError:
                pass
        srv._thread.join(30.0)
        assert not srv._thread.is_alive()       # env-armed crash landed
        assert faults.active_plan().fired("ingest.admit") == 1
        srv._durable.close()

        # recovery (the env spec is spent: count=1) is bit-identical
        srv2 = AsyncServer(cfg, scfg, engine=Engine(cfg, 0, device="cpu"),
                           publish_every=2, durability=dcfg)
        fa = ckpt_lib.flatten_tree(ref.state)
        fb = ckpt_lib.flatten_tree(srv2.engine.state)
        bad = [k for k in fa if not np.array_equal(ckpt_lib.to_host(fa[k]),
                                                   ckpt_lib.to_host(fb[k]))]
        assert not bad, f"leaves differ: {{bad}}"
        srv2.close()
        print("ENV-FAULTS-OK")
    """).format(d=str(tmp_path).replace("\\", "/"))
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": "src"},
                          cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ENV-FAULTS-OK" in proc.stdout


# ------------------------------------------------- lifecycle satellites
def test_close_is_idempotent_and_post_close_submit_raises():
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                      publish_every=2)
    srv.ingest(stream.next_batch(16)["embedding"],
               stream.next_batch(16)["doc_id"])
    srv.close()
    srv.close()   # double close: clean no-op
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(stream.queries(1)["embedding"][0])
    with pytest.raises(RuntimeError, match="closed"):
        srv.ingest(stream.next_batch(4)["embedding"],
                   stream.next_batch(4)["doc_id"])
