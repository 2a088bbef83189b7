"""The port's sharded engine (``engine/sharded.py`` over ``distributed/
collectives.py`` and a ``launch/mesh.py`` mesh of CPU devices) against
the JAX package's host functions, run on one CPU device, and the
reference's sharded invariants ported as port-only tests.

Against the reference: ``ShardedEngine.shard_init_state`` +
``pipeline.ingest_batch`` replay each data shard (the port is fed the
reference's counter draws), ``reconcile_stacked_states`` gives the
snapshot, ``pipeline.query`` answers on it; ``heavy_hitter.merge``,
``docstore.merge_stacked`` / ``scatter_rows`` / ``shard_slice`` and
``stages.delta_upsert_snapshot`` leaf for leaf. The reference's own mesh
paths fail on jax 0.9.0 (ROADMAP C0b); its host functions run.

Tolerances: decisions exact (labels, slots, counts, ids, stamps, ptr,
int8 rows, routes, top-k ids and rows); floats within rtol 1e-5, atol
1e-6 (an fp32 ring row is the shard's admitted unit row, which the two
packages normalize in other summation orders). The merges are gathers:
on the same shard stores they give the reference's rings bit for bit.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.streaming_rag import paper_pipeline_config as j_config
from repro.core import heavy_hitter as j_hh, pipeline as jpipe
from repro.data.streams import make_stream as j_stream
from repro.engine import stages as j_stages
from repro.engine.sharded import (ShardedEngine as JSharded,
                                  reconcile_stacked_states as j_reconcile)
from repro.store import docstore as j_docstore
from repro_torch import convert
from repro_torch.configs.streaming_rag import paper_pipeline_config as t_config
from repro_torch.core import heavy_hitter as t_hh
from repro_torch.data.streams import make_stream
from repro_torch.engine import stages
from repro_torch.engine.engine import Engine, snapshot_query_impl
from repro_torch.engine.plan import QueryPlan
from repro_torch.engine.sharded import (ShardedEngine, reconcile_stacked_states,
                                        reconcile_states, stack_states)
from repro_torch.launch.mesh import (axis_sizes, data_axes, make_debug_mesh,
                                     make_streaming_mesh)
from repro_torch.serve.durability import DurabilityConfig
from repro_torch.serve.runtime import AsyncServer, ServerConfig
from repro_torch.store import docstore
from repro_torch.testing import faults
from repro_torch.train import checkpoint as ckpt_lib

from _torch_parity import assert_trees, ingest_draws, jax_tree

DIM = 32
KW = dict(dim=DIM, k=32, capacity=12, update_interval=48, alpha=-1.0,
          store_depth=4)
SIZES = [64] * 5 + [38]     # a ragged tail batch (38 = 2 * 19)


def _cfgs(store_dtype):
    return (j_config(store_dtype=store_dtype, **KW),
            t_config(store_dtype=store_dtype, **KW))


def _full_store(store) -> docstore.DocStore:
    """A cluster-sharded store (a tuple of shards) as one DocStore."""
    return docstore.DocStore(*(torch.cat(ts) for ts in zip(*store)))


def _np(t):
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# ------------------------------------------------------- the JAX replay
_REPLAYS: dict = {}


def _jax_replay(store_dtype: str, D: int):
    """The reference's per-shard replay of the iot stream (shard inits,
    batches split contiguously, ragged tails padded with dead rows) and
    the counter draws each shard took, cached per (dtype, D)."""
    key = (store_dtype, D)
    if key in _REPLAYS:
        return _REPLAYS[key]
    jc, _ = _cfgs(store_dtype)
    stream = j_stream("iot", dim=DIM)
    batches = [stream.next_batch(s) for s in SIZES]
    queries = np.asarray(stream.queries(16)["embedding"], np.float32)
    states = [JSharded.shard_init_state(jc, jax.random.key(0), s, D)
              for s in range(D)]
    # ingest donates its input state: keep host copies of the shared init
    init = jax.tree.map(np.array, jax_tree(states[0]))
    draws, history = [], []
    for b, bsz in zip(batches, SIZES):
        pad = -bsz % D
        x = np.concatenate([np.asarray(b["embedding"], np.float32),
                            np.zeros((pad, DIM), np.float32)])
        ids = np.concatenate([np.asarray(b["doc_id"], np.int32),
                              np.full((pad,), -1, np.int32)])
        xs, idss = x.reshape(D, -1, DIM), ids.reshape(D, -1)
        step = []
        for s in range(D):
            step.append(ingest_draws(states[s], xs.shape[1], jc.hh.bmax()))
            states[s], _ = jpipe.ingest_batch(jc, states[s],
                                              jnp.asarray(xs[s]),
                                              jnp.asarray(idss[s]))
        draws.append(step)
        history.append(jax.tree.map(lambda *xs: jnp.stack(xs), *states))
    _REPLAYS[key] = dict(batches=batches, queries=queries, init=init,
                         states=states, draws=draws, history=history,
                         snap=j_reconcile(jc, history[-1]))
    return _REPLAYS[key]


def _port_engine(store_dtype, D, M, **kw):
    """The port's engine over a D x M CPU mesh, from the reference's shard
    init, fed the replay's batches and counter draws."""
    rep = _jax_replay(store_dtype, D)
    _, tc = _cfgs(store_dtype)
    eng = ShardedEngine(tc, make_streaming_mesh(D, M, "cpu"),
                        state=convert.state_from_numpy(rep["init"], "cpu"),
                        reconcile_every=10**9, **kw)
    return eng, rep


def _assert_snapshot(jsnap, tsnap):
    store = tsnap.store if isinstance(tsnap.store, docstore.DocStore) \
        else _full_store(tsnap.store)
    assert_trees(jax_tree(jsnap.index),
                 {n: _np(v) for n, v in zip(tsnap.index._fields, tsnap.index)})
    np.testing.assert_array_equal(_np(tsnap.route_labels),
                                  np.asarray(jsnap.route_labels))
    assert_trees(jax_tree(jsnap.store),
                 {n: _np(v) for n, v in zip(store._fields, store)})


def _assert_answers(jout, tout, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_np(tout[0]), np.asarray(jout[0]), rtol=rtol,
                               atol=atol)
    for a, b in zip(jout[1:], tout[1:4]):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


# ------------------------------------------------------------------ mesh
def test_mesh_shapes_axes_and_round_robin_placement():
    mesh = make_streaming_mesh(2, 3, "cpu")
    assert mesh.shape == (2, 3) and mesh.axis_names == ("data", "model")
    assert axis_sizes(mesh) == {"data": 2, "model": 3}
    assert data_axes(mesh) == ("data",)
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    many = make_streaming_mesh(2, 2, ["cpu", "meta"])
    assert [str(d) for d in many.devices.ravel()] == ["cpu", "meta"] * 2
    assert make_debug_mesh((1, 2), devices="cpu").shape == (1, 2)
    with pytest.raises(ValueError, match="one card"):   # no device guard
        make_streaming_mesh(2, 2, ["cuda:0", "cuda:1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_streaming_mesh(2, 2)


# ---------------------------------------------------------------- merges
@pytest.mark.parametrize("policy,morris", [(t_hh.Policy.MIN_EVICT, False),
                                           (t_hh.Policy.SPACE_SAVING, True)])
def test_counter_merge_matches_reference(policy, morris):
    """``heavy_hitter.merge`` on two counters that share labels, with tied
    counts (top-bmax ties to the lowest position) and Morris exponents."""
    jcfg = j_hh.HHConfig(capacity=8, policy=j_hh.Policy(int(policy)),
                         morris=morris, admit_prob=1.0)
    tcfg = t_hh.HHConfig(capacity=8, policy=policy, morris=morris,
                         admit_prob=1.0)
    rng = np.random.default_rng(4)
    states = []
    for _ in range(2):
        s = j_hh.init(jcfg)
        labels = jnp.asarray(rng.integers(0, 14, size=40), jnp.int32)
        s, _ = j_hh.update_batch(jcfg, s, labels, jax.random.key(len(states)))
        states.append(s)
    want = j_hh.merge(jcfg, *states)
    got = t_hh.merge(tcfg, *(t_hh.HHState(*(torch.from_numpy(np.array(a))
                                            for a in st)) for st in states))
    assert_trees(jax_tree(want), {n: _np(v) for n, v in zip(got._fields, got)})
    assert int((got.labels >= 0).sum()) == 8


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_store_merges_and_delta_upsert_match_reference(store_dtype):
    """``merge_stacked`` (all clusters and a row subset), ``scatter_rows``
    (out-of-range rows dropped), ``shard_slice``, and
    ``delta_upsert_snapshot`` against the reference, leaf for leaf."""
    rep = _jax_replay(store_dtype, 2)
    jc, tc = _cfgs(store_dtype)
    jstates = rep["states"]
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jstates)
    tstates = [convert.state_from_numpy(jax_tree(s), "cpu") for s in jstates]
    tstores = stack_states([s.store for s in tstates], "cpu")

    def same(jstore, tstore):
        for name in docstore.DocStore._fields:
            np.testing.assert_array_equal(_np(getattr(tstore, name)),
                                          np.asarray(getattr(jstore, name)),
                                          err_msg=name)

    jm = j_docstore.merge_stacked(jc.store, jstacked.store)
    tm = docstore.merge_stacked(tc.store, tstores)
    same(jm, tm)
    assert int((tm.ids >= 0).sum()) > 0
    rows = np.array([3, 17, 30], np.int64)
    same(j_docstore.merge_stacked(jc.store, jax.tree.map(
             lambda a: a[:, rows], jstacked.store)),
         docstore.merge_stacked(tc.store, docstore.DocStore(
             *(t[:, rows] for t in tstores))))
    idx = np.array([1, 40, 5, 32], np.int32)
    src = jax.tree.map(lambda a: a[:4], jm)
    same(j_docstore.scatter_rows(jm, src, jnp.asarray(idx)),
         docstore.scatter_rows(tm, docstore.DocStore(*(t[:4] for t in tm)),
                               torch.from_numpy(idx)))
    same(j_docstore.shard_slice(jc.store, jm, jnp.int32(1), 2),
         docstore.shard_slice(tc.store, tm, 1, 2))

    # delta upsert from a stale previous index: clusters 0..7 dirty
    jsnap = rep["snap"]
    j_hh_m = jstates[0].hh
    dirty = np.zeros((jc.clus.num_clusters,), bool)
    dirty[:8] = True
    prev_labels = np.roll(np.asarray(j_hh_m.labels), 1)
    cent = np.array(jstates[1].clus.centroids)
    rep_ids = np.array(jstates[1].rep_ids)
    want = j_stages.delta_upsert_snapshot(
        jc.index, jsnap.index, jnp.asarray(prev_labels), j_hh_m,
        jnp.asarray(cent), jnp.asarray(rep_ids), jnp.asarray(dirty))
    prev_t = tstates[0].index._replace(
        vectors=torch.from_numpy(np.array(jsnap.index.vectors)),
        ids=torch.from_numpy(np.array(jsnap.index.ids)),
        valid=torch.from_numpy(np.array(jsnap.index.valid)),
        version=int(jsnap.index.version))
    got = stages.delta_upsert_snapshot(
        tc.index, prev_t, torch.from_numpy(prev_labels), tstates[0].hh,
        torch.from_numpy(cent), torch.from_numpy(rep_ids),
        torch.from_numpy(dirty))
    assert_trees(jax_tree(want[0]),
                 {n: _np(v) for n, v in zip(got[0]._fields, got[0])})
    for a, b in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


@pytest.mark.parametrize("shards", [2, 3])
def test_distributed_mips_equals_one_index(shards):
    """Index rows sharded over ``shards``: the local top-k merged equals
    the top-k over the whole index (global rows, ties to the lowest)."""
    from repro_torch.distributed.collectives import distributed_mips_topk
    from repro_torch.kernels.mips.ops import mips_topk

    rng = np.random.default_rng(shards)
    n, k = 96, 7
    rows = torch.from_numpy(rng.normal(size=(n, DIM)).astype(np.float32))
    rows[50] = rows[10]                      # an exact tie across shards
    valid = torch.from_numpy(rng.random(n) < 0.8)
    valid[[10, 50]] = True
    q = torch.from_numpy(rng.normal(size=(5, DIM)).astype(np.float32))
    q[0] = rows[10]
    per = n // shards
    got = distributed_mips_topk(q, [rows[m * per:(m + 1) * per]
                                    for m in range(shards)],
                                [valid[m * per:(m + 1) * per]
                                 for m in range(shards)], k)
    want = mips_topk(q, rows, valid, k)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert got[1][0, :2].tolist() == [10, 50]


# -------------------------------------------------------- engine parity
@pytest.mark.parametrize("store_dtype,D,M", [("fp32", 2, 2), ("int8", 2, 2),
                                             ("int8", 2, 1), ("int8", 1, 2)])
def test_sharded_engine_matches_reference_host_oracles(store_dtype, D, M):
    """Sharded ingest == the reference's per-shard replay, leaf for leaf;
    the published snapshot == ``reconcile_stacked_states``; prototype-only,
    fused, staged and plan queries == ``pipeline.query`` on it."""
    eng, rep = _port_engine(store_dtype, D, M)
    jc, _ = _cfgs(store_dtype)
    for b, draws in zip(rep["batches"], rep["draws"]):
        eng.ingest(b["embedding"], b["doc_id"], draws=draws)
    for s in range(D):
        assert_trees(jax_tree(rep["states"][s]),
                     convert.state_to_numpy(eng.shards[s]))
    snap = eng.reconcile()
    _assert_snapshot(rep["snap"], snap)
    assert len(snap.store) == M
    assert all(s.ids.shape[0] == jc.clus.num_clusters // M for s in snap.store)

    host = rep["states"][0]._replace(index=rep["snap"].index,
                                     route_labels=rep["snap"].route_labels,
                                     store=rep["snap"].store)
    q = rep["queries"]
    for kw in ({}, {"two_stage": True, "nprobe": 6}):
        _assert_answers(jpipe.query(jc, host, jnp.asarray(q), 5, **kw),
                        eng.query(q, 5, **kw))
    _assert_answers(jpipe.query(jc, host, jnp.asarray(q), 5, two_stage=True,
                                nprobe=6),
                    eng.query_snapshot(snap, q, 5, two_stage=True, nprobe=6,
                                       staged=True))
    _assert_answers(jpipe.query(jc, host, jnp.asarray(q), 5, two_stage=True,
                                nprobe=4, depth=2),
                    eng.query(q, 5, two_stage=True, plan=QueryPlan(4, 2)))
    assert (eng.query(q, 5, two_stage=True, nprobe=6)[2] >= 0).any()
    assert eng.store_bytes_per_device() * M == docstore.memory_bytes(
        eng.cfg.store)


def test_delta_publish_matches_reference_snapshot_at_every_publish():
    """A delta engine fed the replay publishes, at each batch, what the
    reference's host oracle reconciles from the shards at that point."""
    eng, rep = _port_engine("int8", 2, 2, reconcile_mode="delta",
                            delta_max_frac=1.0)
    jc, _ = _cfgs("int8")
    modes = []
    for b, draws, stacked in zip(rep["batches"], rep["draws"],
                                 rep["history"]):
        eng.ingest(b["embedding"], b["doc_id"], draws=draws)
        snap = eng.reconcile()
        modes.append(eng.last_publish_info["mode"])
        _assert_snapshot(j_reconcile(jc, stacked), snap)
    assert "delta" in modes and modes[0] == "full", modes


# ------------------------------------------- the reference's invariants
def _engines(cfg, D=2, M=2, **kw):
    return ShardedEngine(cfg, make_streaming_mesh(D, M, "cpu"), 0,
                         reconcile_every=10**9, **kw)


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_delta_publish_bit_identical_to_full_rebuild(store_dtype):
    """Two engines, one publishing full rebuilds and one delta
    publications, publish leaf-for-leaf identical snapshots at every
    reconcile, through evictions and a ragged tail batch."""
    cfg = t_config(store_dtype=store_dtype, **KW)
    stream = make_stream("iot", dim=DIM)
    full, delta = _engines(cfg), _engines(cfg, reconcile_mode="delta",
                                          delta_max_frac=1.0)
    modes = []
    for i, bsz in enumerate([64] * 7 + [37]):
        b = stream.next_batch(bsz)
        for e in (full, delta):
            e.ingest(b["embedding"], b["doc_id"])
        sf, sd = full.reconcile(), delta.reconcile()
        modes.append(delta.last_publish_info["mode"])
        assert sf.version == sd.version == i + 1
        assert sf.published_at > 0 and sd.published_at > 0
        assert sf.index.version == sd.index.version == 1
        for a, c in zip(sf.index[:3], sd.index[:3]):
            assert torch.equal(a, c)
        assert torch.equal(sf.route_labels, sd.route_labels)
        for m in range(2):
            for a, c in zip(sf.store[m], sd.store[m]):
                assert torch.equal(a, c)
    assert "delta" in modes, modes
    info = delta.last_publish_info
    assert info["dirty_clusters"] == info["dirty"].size
    assert info["dirty_frac"] == info["dirty"].size / cfg.clus.num_clusters
    assert sum(int(s.hh.total_evictions) for s in full.shards) > 0


def test_ragged_batches_equal_the_padded_replay():
    """A ragged batch pads with dead rows (doc id -1); the engine equals
    single-device engines replaying the padded sub-batches from
    ``shard_init_state``, and no padding reaches the store or answers."""
    cfg = t_config(**KW)
    D = 4
    eng = _engines(cfg, D=D, M=1)
    singles = [Engine(cfg, state=ShardedEngine.shard_init_state(
        cfg, 0, s, D, device="cpu")) for s in range(D)]
    stream = make_stream("iot", dim=DIM)
    for bsz in (64, 61, 64, 39):
        b = stream.next_batch(bsz)
        eng.ingest(b["embedding"], b["doc_id"])
        pad = -bsz % D
        x = np.concatenate([b["embedding"], np.zeros((pad, DIM), np.float32)])
        ids = np.concatenate([b["doc_id"], np.full((pad,), -1, np.int32)])
        for s, single in enumerate(singles):
            single.ingest(x.reshape(D, -1, DIM)[s], ids.reshape(D, -1)[s])
    for s, single in enumerate(singles):
        assert_trees(convert.state_to_numpy(single.state),
                     convert.state_to_numpy(eng.shards[s]), rtol=0, atol=0)
        assert torch.equal(single.state.gen.get_state(),
                           eng.shards[s].gen.get_state())
    snap = eng.reconcile()
    store = _full_store(snap.store)
    assert bool((store.stamps[store.ids >= 0] >= 0).all())
    ids = eng.query(stream.queries(8)["embedding"], 5, two_stage=True,
                    nprobe=6)[2]
    assert bool(((ids >= 0) | (ids == -1)).all()) and bool((ids >= 0).any())


def test_reconcile_carries_ring_buffers_exactly():
    """Four data shards from different seeds: the published store is the
    exact ring union (``merge_stacked``), and ``reconcile_states`` (the
    oracle every path composes) equals the engine's publish."""
    cfg = t_config(**dict(KW, capacity=16, update_interval=64))
    stream = make_stream("iot", dim=DIM)
    eng = _engines(cfg, D=4, M=2)
    for _ in range(3):
        b = stream.next_batch(64)
        eng.ingest(b["embedding"], b["doc_id"])
    snap = eng.reconcile()
    want = docstore.merge_stacked(cfg.store, stack_states(
        [s.store for s in eng.shards], "cpu"))
    got = _full_store(snap.store)
    for a, c in zip(want, got):
        assert torch.equal(a, c)
    assert int(docstore.size(got)) > 0
    for oracle in (reconcile_states(cfg, eng.shards),
                   reconcile_stacked_states(cfg, eng.checkpoint_state())):
        for a, c in zip((*oracle.index[:3], oracle.route_labels, *oracle.store),
                        (*snap.index[:3], snap.route_labels, *got)):
            assert torch.equal(a, c)


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_sharded_serve_equals_single_device_and_staged(store_dtype):
    """Fused sharded serve == staged sharded (route + rerank) == the
    single-device fused query over the gathered snapshot; a degraded plan
    too (ids, rows, clusters exact, scores bit-equal: the same kernels on
    the same rows), and a full-effort plan == plan-free."""
    cfg = t_config(**dict(KW, k=16, update_interval=32, store_depth=8,
                          store_dtype=store_dtype))
    eng = ShardedEngine(cfg, make_streaming_mesh(2, 2, "cpu"), 0,
                        reconcile_every=100)
    rng = np.random.default_rng(3)
    for b in range(4):
        eng.ingest(rng.normal(size=(32, DIM)).astype(np.float32),
                   np.arange(32, dtype=np.int32) + 32 * b)
    snap = eng.reconcile()
    q = torch.from_numpy(rng.normal(size=(9, DIM)).astype(np.float32))
    store = _full_store(snap.store)
    for plan in (None, QueryPlan(4, 4)):
        fused = eng.query_snapshot(snap, q, 6, two_stage=True, nprobe=4,
                                   plan=plan)
        staged = eng.query_snapshot(snap, q, 6, two_stage=True, nprobe=4,
                                    plan=plan, staged=True)
        single = snapshot_query_impl(cfg, snap.index, snap.route_labels,
                                     store, q, 6, two_stage=True, nprobe=4,
                                     depth=None if plan is None else plan.depth)
        for a, b2, c in zip(fused, staged, single):
            assert torch.equal(a, c) and torch.equal(b2, c)
        assert bool((fused[2] >= 0).any())
    base = eng.query_snapshot(snap, q, 6, two_stage=True, nprobe=4)
    full = eng.query_snapshot(snap, q, 6, two_stage=True,
                              plan=QueryPlan(nprobe=4, depth=8))
    for a, b2 in zip(base, full):
        assert torch.equal(a, b2)


def test_device_counters_aggregate_across_shards():
    cfg = t_config(**KW)
    eng = _engines(cfg, reconcile_mode="delta")
    stream = make_stream("iot", dim=DIM)
    for _ in range(2):
        b = stream.next_batch(64)
        eng.ingest(b["embedding"], b["doc_id"])
        eng.reconcile()
    c = eng.device_counters()
    per = [stages.decode_pipeline_counters(stages.pipeline_counters(
        cfg, s)[None].numpy()) for s in eng.shards]
    assert c["arrivals"] == 128 == sum(p["arrivals"] for p in per)
    assert c["store_slots"] == 2 * cfg.clus.num_clusters * cfg.store_depth
    assert c["store_min_fill"] == min(p["store_min_fill"] for p in per)
    assert c["index_valid"] == max(p["index_valid"] for p in per)
    assert eng.last_publish_info["mode"] in ("delta", "republish", "full")
    assert c["publish_dirty_frac"] <= 1.0


def test_sharded_crash_recovery_bit_identical(tmp_path):
    """Checkpoint the stacked state, crash the server mid-stream, recover:
    every shard's state equals the uncrashed engine's leaf for leaf, and
    the recovered snapshot answers identically."""
    cfg = t_config(**KW)
    scfg = ServerConfig(max_batch=8, topk=5, two_stage=True, nprobe=4)
    stream = make_stream("iot", dim=DIM)
    batches = [stream.next_batch(64) for _ in range(8)]
    ref = _engines(cfg, D=4, M=1)
    for b in batches:
        ref.ingest(b["embedding"], b["doc_id"])
    dcfg = DurabilityConfig(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    srv = AsyncServer(cfg, scfg, engine=_engines(cfg, D=4, M=1),
                      publish_every=4, durability=dcfg)
    with faults.inject("ingest.admit:crash@6"):
        for b in batches:
            try:
                srv.ingest(b["embedding"], b["doc_id"])
            except RuntimeError:
                pass   # the thread died; the batch was journaled first
        srv._thread.join(60.0)
        assert not srv._thread.is_alive()
    srv._durable.close()
    eng2 = _engines(cfg, D=4, M=1)
    srv2 = AsyncServer(cfg, scfg, engine=eng2, publish_every=4,
                       durability=dcfg)
    rep = srv2.recovery_report
    assert rep is not None and rep["applied_seq"] == len(batches) - 1
    assert rep["checkpoint_seq"] is not None and rep["replayed"] > 0
    fa = ckpt_lib.flatten_tree(ref.checkpoint_state())
    fb = ckpt_lib.flatten_tree(eng2.checkpoint_state())
    assert fa.keys() == fb.keys()
    bad = [k for k in fa if not np.array_equal(ckpt_lib.to_host(fa[k]),
                                               ckpt_lib.to_host(fb[k]))]
    assert not bad, f"leaves differ: {bad}"
    q = stream.queries(8)["embedding"]
    want = ref.query_snapshot(ref.reconcile(), q, 5, two_stage=True, nprobe=4)
    got = eng2.query_snapshot(eng2.reconcile(), q, 5, two_stage=True, nprobe=4)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    srv2.close(timeout=60)


def test_delta_publish_invalidates_cache_precisely():
    """A small delta publish dirties a cluster subset: entries routed
    clear of it keep serving (hits, bit-equal to the fresh snapshot's
    answers), exactly the entries through it are invalidated."""
    cfg = t_config(dim=DIM, k=24, capacity=24, alpha=0.1, admit_prob=1.0,
                   update_interval=10**9, store_depth=4)
    stream = make_stream("iot", dim=DIM)
    eng = _engines(cfg, reconcile_mode="delta")
    srv = AsyncServer(cfg, ServerConfig(max_batch=8, max_wait_ms=0.0, topk=5,
                                        two_stage=True, nprobe=2,
                                        cache_entries=64),
                      engine=eng, publish_every=10**9)
    for _ in range(6):
        b = stream.next_batch(64)
        srv.ingest(b["embedding"], b["doc_id"])
    srv.sync(timeout=60)
    pool = np.asarray(stream.queries(16)["embedding"], np.float32)

    def ask(qs):
        ts = [srv.submit(qv) for qv in qs]
        outs = []
        for _ in range(100):
            if len(outs) >= len(ts):
                break
            outs += srv.flush()
        return {o["ticket"]: o for o in outs}, ts

    a1, t1 = ask(pool)
    cache = srv._result_cache
    assert len(cache) == 16, len(cache)
    hits0 = cache.hits
    snap_old = srv._snapshot
    old_routes = stages.route(cfg.index, snap_old.index, snap_old.route_labels,
                              torch.from_numpy(pool), 2).numpy()

    def touched(dirty_set):
        return np.array([np.isin(r[r >= 0], dirty_set).any()
                         for r in old_routes])

    dirty = np.array([], np.int32)
    for _ in range(20):
        b = stream.next_batch(8)
        srv.ingest(b["embedding"], b["doc_id"])
        srv.sync(timeout=60)
        info = eng.last_publish_info
        assert info["mode"] in ("delta", "republish"), info
        dirty = np.union1d(dirty, np.asarray(info["dirty"]).ravel())
        hit = touched(dirty)
        if hit.any() and not hit.all():
            break
    assert 0 < dirty.size < cfg.clus.num_clusters, dirty
    a2, t2 = ask(pool)
    snap = srv._snapshot
    new_routes = stages.route(cfg.index, snap.index, snap.route_labels,
                              torch.from_numpy(pool), 2).numpy()
    clean = np.array([np.array_equal(o, n) and not np.isin(o[o >= 0], dirty).any()
                      for o, n in zip(old_routes, new_routes)])
    assert clean.any() and not clean.all()
    assert cache.hits - hits0 == int(clean.sum())
    assert cache.invalidated > 0 and cache.rekeyed > 0
    for i, (to, tn) in enumerate(zip(t1, t2)):
        if clean[i]:
            np.testing.assert_array_equal(a1[to]["doc_ids"], a2[tn]["doc_ids"])
            np.testing.assert_array_equal(a1[to]["scores"], a2[tn]["scores"])
        want = eng.query_snapshot(snap, pool[i][None], 5, two_stage=True,
                                  nprobe=2)
        np.testing.assert_array_equal(a2[tn]["doc_ids"], want[2][0].numpy())
        np.testing.assert_array_equal(a2[tn]["scores"], want[0][0].numpy())
    srv.close(timeout=60)


def test_flush_does_not_wait_behind_a_publish_prepare():
    """The async runtime runs the engine's ``prepare_publish`` outside its
    dispatch section: while a publish's prepare is held up, a flush from
    the caller's thread still answers."""
    cfg = t_config(**KW)
    entered, release = threading.Event(), threading.Event()

    class SlowPrepare(ShardedEngine):
        def prepare_publish(self):
            entered.set()
            assert release.wait(30), "the prepare was never released"
            super().prepare_publish()

    eng = SlowPrepare(cfg, make_streaming_mesh(2, 2, "cpu"), 0,
                      reconcile_every=10**9, reconcile_mode="delta")
    srv = AsyncServer(cfg, ServerConfig(max_batch=4, max_wait_ms=0.0, topk=5,
                                        two_stage=True, nprobe=4),
                      engine=eng, publish_every=1)
    stream = make_stream("iot", dim=DIM)
    try:
        for qv in stream.queries(4)["embedding"]:
            srv.submit(qv)
        b = stream.next_batch(64)
        srv.ingest(b["embedding"], b["doc_id"])
        assert entered.wait(30), "the publish never reached its prepare"
        done = []
        t = threading.Thread(target=lambda: done.extend(srv.flush()))
        t0 = time.monotonic()
        t.start()
        t.join(20)
        assert not t.is_alive() and len(done) == 4, "the flush waited"
        assert time.monotonic() - t0 < 20
        assert all(a["snapshot_version"] == 1 for a in done)
    finally:
        release.set()
    srv.sync(timeout=60)
    assert srv._snapshot.version >= 2
    assert eng.last_publish_info["mode"] in ("delta", "republish")
    srv.close(timeout=60)
