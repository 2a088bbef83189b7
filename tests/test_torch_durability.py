"""The port's crash-safe streaming (``tests/test_durability.py`` on
``repro_torch``), and the port held against the JAX package.

The contract under test is BIT-IDENTITY: for a seeded stream, an engine
recovered from (last durable checkpoint + journal-tail replay) is
leaf-for-leaf equal to the engine that never crashed — and so are its
subsequent query answers. Pinned here for

  * a crash at an arbitrary batch boundary AND a crash mid-replay
    (recovery of a failed recovery),
  * both store dtypes (fp32 and int8),
  * the single-device ``Engine`` (the sharded engine is ROADMAP A8).

Plus the mechanics underneath: torn-tail detection, monotone seqs,
segment truncation only behind a durable checkpoint, delta checkpoints
that restore exactly like fulls, and a failed checkpoint write that
never advances the dirty baseline (nothing is lost, the next save
covers it).

Against the JAX package: the journal's files are byte-identical for the
same batches and each package replays the other's; and with
``admit_prob=1.0`` and MIN_EVICT (no random draw decides anything) the
port's recovered state equals the reference's recovered state after the
same crash, leaf for leaf (decisions exact, floats within rtol 1e-5).
"""
import faulthandler
import os
import sys
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.configs.streaming_rag import paper_pipeline_config as j_config
from repro.core import pipeline as jpipe
from repro.engine.engine import Engine as JEngine
from repro.serve import durability as jdur
from repro.serve.runtime import AsyncServer as JAsyncServer
from repro.serve.runtime import ServerConfig as JServerConfig
from repro.testing import faults as jfaults
from repro_torch import convert
from repro_torch.configs.streaming_rag import paper_pipeline_config as t_config
from repro_torch.core import clustering, heavy_hitter, pipeline, prefilter
from repro_torch.data.streams import make_stream
from repro_torch.engine.engine import Engine
from repro_torch.serve.durability import (CheckpointStore, DurabilityConfig,
                                          IngestJournal, classify_error,
                                          replay_journal)
from repro_torch.serve.runtime import AsyncServer, ServerConfig
from repro_torch.testing import faults
from repro_torch.train import checkpoint as ckpt_lib

from _torch_parity import assert_trees, jax_tree

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


# ---------------------------------------------------------------- journal
def test_journal_roundtrip_and_monotone_seqs(tmp_path):
    j = IngestJournal(str(tmp_path), segment_bytes=1 << 12)
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((4, DIM)).astype(np.float32),
                np.arange(4, dtype=np.int32) + 4 * i) for i in range(9)]
    for i, (x, ids) in enumerate(batches):
        j.append(i, x, ids)
    assert j.last_seq() == 8
    got = list(j.replay(0))
    assert [s for s, _x, _i in got] == list(range(9))
    for (s, x, ids), (wx, wids) in zip(got, batches):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(ids, wids)
    # a tail replay starts where asked
    assert [s for s, _x, _i in j.replay(6)] == [6, 7, 8]
    # seqs must stay monotone — a skipped seq is a hole replay can't fill
    with pytest.raises(AssertionError, match="monotone"):
        j.append(42, *batches[0])
    # a fresh handle over the same directory resumes the seq chain
    j.close()
    j2 = IngestJournal(str(tmp_path), segment_bytes=1 << 12)
    assert j2.last_seq() == 8
    j2.append(9, *batches[0])
    j2.close()


def test_journal_torn_tail_is_dropped(tmp_path):
    j = IngestJournal(str(tmp_path), segment_bytes=1 << 20)
    x = np.ones((4, DIM), np.float32)
    for i in range(3):
        j.append(i, x * i, np.arange(4, dtype=np.int32))
    j.close()
    seg = [f for f in os.listdir(tmp_path) if f.endswith(".wal")][0]
    path = os.path.join(str(tmp_path), seg)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:  # tear the last record mid-payload
        f.truncate(size - 7)
    j2 = IngestJournal(str(tmp_path))
    assert [s for s, _x, _i in j2.replay(0)] == [0, 1]  # tail dropped
    assert j2.last_seq() == 1
    # ... and the journal keeps appending right after the torn record
    j2.append(2, x, np.arange(4, dtype=np.int32))
    assert [s for s, _x, _i in j2.replay(0)] == [0, 1, 2]
    j2.close()


def test_journal_truncate_only_covered_segments(tmp_path):
    # tiny segments: every append rolls a new one
    j = IngestJournal(str(tmp_path), segment_bytes=1)
    x = np.ones((4, DIM), np.float32)
    for i in range(5):
        j.append(i, x, np.arange(4, dtype=np.int32))
    assert j.stats()["segments"] == 5
    j.truncate(2)  # covers seqs 0..2 -> segments holding them go
    assert [s for s, _x, _i in j.replay(0)] == [3, 4]
    # the active segment survives even when fully covered
    j.truncate(4)
    assert j.stats()["segments"] == 1
    assert [s for s, _x, _i in j.replay(0)] == [4]
    j.close()


# ------------------------------------------------------------- checkpoints
def _ingest_n(eng, stream, n, b=16):
    batches = [stream.next_batch(b) for _ in range(n)]
    for bb in batches:
        eng.ingest(bb["embedding"], bb["doc_id"])
    return batches


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_delta_checkpoint_restores_exactly(tmp_path, store_dtype):
    cfg = small_cfg(store_depth=4, store_dtype=store_dtype)
    stream = make_stream("iot", dim=DIM)
    eng = new_engine(cfg)
    store = CheckpointStore(str(tmp_path), cluster_axis=0)

    _ingest_n(eng, stream, 3)
    out = store.save(2, eng.state, blocking=True)
    assert out["mode"] == "full"
    _ingest_n(eng, stream, 2)
    out = store.save(4, eng.state, blocking=True)
    assert out["mode"] == "delta"
    _ingest_n(eng, stream, 2)
    out = store.save(6, eng.state, blocking=True)
    assert out["mode"] == "delta"  # chains: full + delta + delta

    restored, meta = store.restore(eng.state)
    assert meta["seq"] == 6
    assert_leaves_identical(eng.state, restored)


def test_checkpoint_write_failure_never_advances_baseline(tmp_path):
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    eng = new_engine(cfg)
    store = CheckpointStore(str(tmp_path), cluster_axis=0)
    _ingest_n(eng, stream, 2)
    store.save(1, eng.state, blocking=True)
    state_at_1 = ckpt_lib.unflatten_arrays(
        eng.state, {k: ckpt_lib.to_host(v)
                    for k, v in ckpt_lib.flatten_tree(eng.state).items()})

    _ingest_n(eng, stream, 2)
    with faults.inject("checkpoint.write:raise@1") as plan:
        store.save(3, eng.state)
        store.wait()
    assert plan.fired("checkpoint.write") == 1
    assert store.saves["failed"] == 1
    assert store.poll_error(raise_=False) is not None
    # the failed save changed nothing durable: restore still yields seq 1
    restored, meta = store.restore(eng.state)
    assert meta["seq"] == 1
    assert_leaves_identical(state_at_1, restored)
    # ... and the NEXT save covers everything since seq 1 (baseline did
    # not advance), so restore equals the live state again
    out = store.save(3, eng.state, blocking=True)
    assert out["mode"] == "delta"
    restored, meta = store.restore(eng.state)
    assert meta["seq"] == 3
    assert_leaves_identical(eng.state, restored)


def test_replay_quarantines_poison_batch(tmp_path):
    j = IngestJournal(str(tmp_path))
    x = np.ones((4, DIM), np.float32)
    for i in range(4):
        j.append(i, x * i, np.arange(4, dtype=np.int32))

    applied = []

    def apply(x, ids):
        if int(x[0, 0]) == 2:  # batch seq 2 is poison
            raise faults.InjectedFault("poison")
        applied.append(int(x[0, 0]))

    report = replay_journal(j, 0, apply, quarantine_after=3)
    assert applied == [0, 1, 3]
    assert report.quarantined == [2]   # counted + named, never silent
    assert report.replayed == 3
    # fatal errors are NOT retried or quarantined — they surface
    with pytest.raises(faults.InjectedFatal):
        replay_journal(j, 0,
                       lambda x, ids: (_ for _ in ()).throw(
                           faults.InjectedFatal("bug")),
                       quarantine_after=3)
    j.close()


def test_classify_error():
    assert classify_error(faults.InjectedFault("x")) == "transient"
    assert classify_error(faults.InjectedFatal("x")) == "fatal"
    assert classify_error(TimeoutError()) == "transient"
    assert classify_error(ValueError("shape")) == "fatal"
    assert classify_error(AssertionError()) == "fatal"


# ----------------------------------------------------- recovery bit-identity
def _reference_engine(cfg, batches):
    ref = new_engine(cfg)
    for b in batches:
        ref.ingest(b["embedding"], b["doc_id"])
    return ref


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("crash_at", [3, 7])
def test_crash_recovery_bit_identical(tmp_path, store_dtype, crash_at):
    """Crash at an arbitrary batch boundary; recover; compare leaf-for-
    leaf with the uncrashed run AND the query answers."""
    cfg = small_cfg(store_depth=4, store_dtype=store_dtype)
    stream = make_stream("iot", dim=DIM)
    batches = [stream.next_batch(16) for _ in range(10)]
    ref = _reference_engine(cfg, batches)

    dcfg = DurabilityConfig(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                      publish_every=2, durability=dcfg)
    with faults.inject(f"ingest.admit:crash@{crash_at + 1}"):
        for b in batches:
            try:
                srv.ingest(b["embedding"], b["doc_id"])
            except RuntimeError:
                # the thread already died: the journal append happens
                # BEFORE the enqueue, so this batch is durable regardless
                pass
        # the ingest thread died mid-stream (simulated SIGKILL) — but
        # queries keep answering from the pinned snapshot
        srv._thread.join(30.0)
        assert not srv._thread.is_alive()
    q = stream.queries(4)["embedding"]
    for qv in q:
        srv.submit(qv)
    out = srv.drain()
    assert len(out) == 4 and all(o["doc_ids"].shape == (5,) for o in out)
    srv._durable.close()

    # recovery into a fresh process-equivalent: same cfg, same init key
    srv2 = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                       publish_every=2, durability=dcfg)
    rep = srv2.recovery_report
    assert rep is not None and rep["quarantined"] == []
    # every journaled batch is applied: checkpointed prefix + replay tail
    assert rep["applied_seq"] == len(batches) - 1
    assert_leaves_identical(ref.state, srv2.engine.state)

    # subsequent answers are identical to the uncrashed engine's
    snap_ref, snap_rec = ref.publish(), srv2.engine.publish()
    want = ref.query_snapshot(snap_ref, q, 5, two_stage=True, nprobe=4)
    got = srv2.engine.query_snapshot(snap_rec, q, 5, two_stage=True,
                                     nprobe=4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.numpy(), g.numpy())
    srv2.close()


def test_mid_replay_crash_then_second_recovery_bit_identical(tmp_path):
    """A crash DURING recovery replay must leave the durable state intact:
    the next recovery starts over and still lands bit-identical."""
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    batches = [stream.next_batch(16) for _ in range(8)]
    ref = _reference_engine(cfg, batches)

    dcfg = DurabilityConfig(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                      publish_every=2, durability=dcfg)
    with faults.inject("ingest.admit:crash@6"):
        for b in batches:
            try:
                srv.ingest(b["embedding"], b["doc_id"])
            except RuntimeError:
                pass  # thread already dead; batch journaled before _put
        srv._thread.join(30.0)
    srv._durable.close()

    # first recovery crashes mid-replay (second replayed batch)
    with faults.inject("replay:crash@2"):
        with pytest.raises(faults.InjectedCrash):
            AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                        publish_every=2, durability=dcfg)
    # the durable state was not touched: a second recovery completes and
    # is bit-identical to the uncrashed run
    srv2 = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                       publish_every=2, durability=dcfg)
    assert srv2.recovery_report["quarantined"] == []
    assert_leaves_identical(ref.state, srv2.engine.state)
    srv2.close()


def test_recovery_resumes_the_stream_seamlessly(tmp_path):
    """Post-recovery ingest continues the seq chain and stays identical
    to an uncrashed engine that saw the whole stream."""
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    batches = [stream.next_batch(16) for _ in range(12)]
    ref = _reference_engine(cfg, batches)

    dcfg = DurabilityConfig(checkpoint_dir=str(tmp_path), checkpoint_every=4)
    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                      publish_every=2, durability=dcfg)
    with faults.inject("ingest.admit:crash@5"):
        for b in batches[:8]:
            try:
                srv.ingest(b["embedding"], b["doc_id"])
            except RuntimeError:
                pass  # thread already dead; batch journaled before _put
        srv._thread.join(30.0)
    srv._durable.close()

    srv2 = AsyncServer(cfg, scfg(), engine=new_engine(cfg),
                       publish_every=2, durability=dcfg)
    for b in batches[8:]:   # the stream resumes where it left off
        srv2.ingest(b["embedding"], b["doc_id"])
    srv2.sync()
    assert srv2.robustness_stats()["journal_last_seq"] == len(batches) - 1
    assert_leaves_identical(ref.state, srv2.engine.state)
    fresh = srv2.freshness_stats()
    assert fresh["lag_docs"] == 0
    srv2.close()


# ------------------------------------------------------- against the JAX one
def _batches(n, b=16, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, DIM)).astype(np.float32),
             np.arange(i * b, (i + 1) * b, dtype=np.int32)) for i in range(n)]


@pytest.mark.parametrize("segment_bytes", [1, 1 << 12, 1 << 20])
def test_journal_files_byte_identical_and_cross_replay(tmp_path,
                                                       segment_bytes):
    batches = _batches(7)
    batches[3] = (batches[3][0].astype(np.float16), batches[3][1])
    batches[5] = ((batches[5][0] * 40).astype(np.int8), batches[5][1])
    batches[6][1][-3:] = -1                      # dead padding rows
    dirs = {}
    for name, cls in (("jax", jdur.IngestJournal), ("torch", IngestJournal)):
        d = str(tmp_path / name)
        j = cls(d, segment_bytes=segment_bytes, fsync=False)
        for seq, (x, ids) in enumerate(batches):
            j.append(seq, x, ids)
        j.truncate(2)
        j.close()
        dirs[name] = d
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["torch"])) and names
    for n in names:
        with open(os.path.join(dirs["jax"], n), "rb") as a, \
                open(os.path.join(dirs["torch"], n), "rb") as b:
            assert a.read() == b.read(), n
    # each package replays the journal the other wrote
    for reader, writer in ((IngestJournal, "jax"),
                           (jdur.IngestJournal, "torch")):
        got = list(reader(dirs[writer]).replay(0))
        first = got[0][0]
        assert [s for s, _x, _i in got] == list(range(first, 7))
        for seq, x, ids in got:
            assert x.dtype == batches[seq][0].dtype
            np.testing.assert_array_equal(x, batches[seq][0])
            np.testing.assert_array_equal(ids, batches[seq][1])


def test_reference_journal_recovers_in_the_port(tmp_path):
    """A journal the reference's durable producer wrote (no checkpoint)
    recovers in the port exactly as the port's own would."""
    cfg = small_cfg(store_depth=4)
    stream = make_stream("iot", dim=DIM)
    batches = [stream.next_batch(16) for _ in range(5)]
    jd = jdur.DurableIngest(jdur.DurabilityConfig(
        checkpoint_dir=str(tmp_path)))
    for b in batches:
        jd.record(np.asarray(b["embedding"]), np.asarray(b["doc_id"]))
    jd.close()
    dcfg = DurabilityConfig(checkpoint_dir=str(tmp_path))
    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg), publish_every=2,
                      durability=dcfg)
    assert srv.recovery_report["replayed"] == 5
    assert_leaves_identical(_reference_engine(cfg, batches).state,
                            srv.engine.state)
    srv.close()


PKW = dict(dim=DIM, k=16, capacity=16, store_depth=4, update_interval=48,
           alpha=0.05, admit_prob=1.0)


def _crash_and_recover(make_server, batches, crash_at, tmp, inject):
    """Ingest ``batches`` into a durable server whose ingest thread dies
    at admit hit ``crash_at``, then recover a second one from the same
    directories; returns the recovered server."""
    srv = make_server(tmp)
    with inject(f"ingest.admit:crash@{crash_at}"):
        for x, ids in batches:
            try:
                srv.ingest(x, ids)
            except RuntimeError:
                pass  # thread already dead; batch journaled before _put
        srv._thread.join(30.0)
        assert not srv._thread.is_alive()
    srv._durable.close()
    return make_server(tmp)


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_recovered_state_matches_reference_recovery(tmp_path, store_dtype):
    """With every draw inert (admit_prob=1.0, MIN_EVICT) both packages'
    recovered states after the same crash agree leaf for leaf."""
    jc = j_config(store_dtype=store_dtype, **PKW)
    tc = t_config(store_dtype=store_dtype, **PKW)
    rng = np.random.default_rng(17)
    warm = rng.normal(size=(64, DIM)).astype(np.float32)
    batches = [(rng.normal(size=(24, DIM)).astype(np.float32),
                np.arange(i * 24, (i + 1) * 24, dtype=np.int32))
               for i in range(9)]
    batches[4][1][-4:] = -1

    def j_server(tmp):
        st = jpipe.init(jc, jax.random.key(17), jnp.asarray(warm))
        eng = JEngine(jc, jax.random.key(17), state=st)
        return JAsyncServer(
            jc, JServerConfig(max_batch=8, topk=5, two_stage=True, nprobe=4),
            engine=eng, publish_every=2,
            durability=jdur.DurabilityConfig(checkpoint_dir=tmp,
                                             checkpoint_every=3))

    def t_server(tmp):
        st = jpipe.init(jc, jax.random.key(17), jnp.asarray(warm))
        eng = Engine(tc, state=convert.state_from_numpy(jax_tree(st), "cpu"))
        return AsyncServer(
            tc, ServerConfig(max_batch=8, topk=5, two_stage=True, nprobe=4),
            engine=eng, publish_every=2,
            durability=DurabilityConfig(checkpoint_dir=tmp,
                                        checkpoint_every=3))

    jsrv = _crash_and_recover(j_server, batches, 8, str(tmp_path / "jax"),
                              jfaults.inject)
    tsrv = _crash_and_recover(t_server, batches, 8, str(tmp_path / "torch"),
                              faults.inject)
    for key in ("checkpoint_seq", "replayed", "quarantined", "docs_replayed",
                "docs_checkpointed", "applied_seq"):
        assert tsrv.recovery_report[key] == jsrv.recovery_report[key], key
    assert tsrv.recovery_report["applied_seq"] == len(batches) - 1
    assert_trees(jax_tree(jsrv.engine.state),
                 convert.state_to_numpy(tsrv.engine.state))
    js, ts = jsrv.robustness_stats(), tsrv.robustness_stats()
    for key in ("journal_last_seq", "journal_segments", "journal_disk_bytes",
                "checkpoint_seq", "quarantined"):
        assert ts[key] == js[key], key
    jsrv.close()
    tsrv.close()


def test_durable_server_refuses_draws(tmp_path):
    cfg = small_cfg(store_depth=4)
    b = make_stream("iot", dim=DIM).next_batch(16)
    srv = AsyncServer(cfg, scfg(), engine=new_engine(cfg), publish_every=2,
                      durability=DurabilityConfig(
                          checkpoint_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="draws"):
        srv.ingest(b["embedding"], b["doc_id"],
                   draws={"uniforms": np.zeros(16, np.float32)})
    assert srv.robustness_stats()["journal_last_seq"] == -1  # not journaled
    srv.close()
