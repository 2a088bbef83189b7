"""The port's slice end to end against the JAX reference: per-microbatch
ingest, both query modes, snapshot queries and the synchronous server.

The JAX ``PipelineState`` is initialised once and carried over with
``convert.state_from_numpy``; both packages then ingest the same
microbatches, the port fed the heavy-hitter uniforms the reference draws.

Tolerances: every integer and bool state leaf exact; float leaves within
rtol 1e-5 / atol 1e-6 (sums run in other orders: centroids, scores,
sims); int8 ring rows exact (the rows are the same words: the ring
writes the admit rows, which differ only where v/scale sits on a
half-integer, and the inputs here hold none). Query ids, rows and
clusters exact; scores within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.streaming_rag import paper_pipeline_config as j_config
from repro.core import pipeline as jpipe
from repro.engine.engine import Engine as JEngine
from repro.serve.server import RAGServer as JServer, ServerConfig as JServerConfig
from repro_torch import convert
from repro_torch.configs.streaming_rag import paper_pipeline_config as t_config
from repro_torch.core import pipeline as tpipe
from repro_torch.engine.engine import Engine as TEngine
from repro_torch.engine.plan import QueryPlan
from repro_torch.serve.server import RAGServer as TServer, ServerConfig as TServerConfig

from _torch_parity import assert_trees, ingest_draws, jax_tree

D, B = 32, 48
KW = dict(dim=D, k=16, capacity=16, store_depth=4, update_interval=100,
          alpha=0.05, admit_prob=0.5)


def _configs(store_dtype):
    return (j_config(store_dtype=store_dtype, **KW),
            t_config(store_dtype=store_dtype, **KW))


def _start(store_dtype, seed=0):
    jc, tc = _configs(store_dtype)
    rng = np.random.default_rng(seed)
    warm = rng.normal(size=(64, D)).astype(np.float32)
    js = jpipe.init(jc, jax.random.key(seed), jnp.asarray(warm))
    return jc, tc, js, convert.state_from_numpy(jax_tree(js), "cpu"), rng


def _batch(rng, step, ragged):
    x = rng.normal(size=(B, D)).astype(np.float32)
    ids = np.arange(step * B, (step + 1) * B, dtype=np.int32)
    if ragged and step % 2 == 1:
        ids[-11:] = -1          # dead padding rows
        x[-11:] = 0.0
    return x, ids


def _assert_query(jout, tout):
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("store_dtype,ragged", [("fp32", False),
                                                ("int8", False),
                                                ("int8", True)])
def test_slice_end_to_end_leaf_for_leaf(store_dtype, ragged):
    jc, tc, js, ts, rng = _start(store_dtype)
    for step in range(8):
        x, ids = _batch(rng, step, ragged)
        draws = ingest_draws(js, B, jc.hh.bmax())
        js, jinfo = jpipe.ingest_batch(jc, js, jnp.asarray(x), jnp.asarray(ids))
        ts, tinfo = tpipe.ingest_batch(tc, ts, x, ids, draws=draws)
        assert_trees(jax_tree(js), convert.state_to_numpy(ts))
        np.testing.assert_array_equal(tinfo["stored"].numpy(),
                                      np.asarray(jinfo["stored"]))
        assert tinfo["host_syncs"] == 1
    assert ts.upserts >= 2 and int(ts.index.valid.sum()) > 0
    assert int(ts.store.ids.ge(0).sum()) > 0

    q = rng.normal(size=(9, D)).astype(np.float32)
    for two_stage in (False, True):
        _assert_query(
            jpipe.query(jc, js, jnp.asarray(q), 5, two_stage=two_stage,
                        nprobe=4),
            tpipe.query(tc, ts, torch.from_numpy(q), 5, two_stage=two_stage,
                        nprobe=4))
    # a depth-clipped plan reads a view of the rings
    _assert_query(jpipe.query(jc, js, jnp.asarray(q), 5, two_stage=True,
                              nprobe=4, depth=2),
                  TEngine(tc, state=ts).query(q, 5, two_stage=True,
                                              plan=QueryPlan(4, 2)))


def test_query_snapshot_matches_and_is_isolated_from_ingest():
    jc, tc, js, ts, rng = _start("int8", seed=1)
    jeng, teng = JEngine(jc, jax.random.key(1), state=js), TEngine(tc, state=ts)
    for step in range(5):
        x, ids = _batch(rng, step, False)
        draws = ingest_draws(jeng.state, B, jc.hh.bmax())
        jeng.ingest(x, ids)
        teng.ingest(x, ids, draws=draws)
    jsnap, tsnap = jeng.publish(), teng.publish()
    assert teng.last_publish_info["mode"] == "full"
    assert teng.index_size() == jeng.index_size() > 0
    assert teng.device_counters() == jeng.device_counters()
    q = rng.normal(size=(6, D)).astype(np.float32)
    before = [teng.query_snapshot(tsnap, q, 5, two_stage=t, nprobe=4)
              for t in (False, True)]
    for t, got in zip((False, True), before):
        _assert_query(jeng.query_snapshot(jsnap, q, 5, two_stage=t, nprobe=4),
                      got)
    # ingest writes the live state in place; the snapshot must not move
    for step in range(5, 8):
        teng.ingest(*_batch(rng, step, False))
    for t, old in zip((False, True), before):
        new = teng.query_snapshot(tsnap, q, 5, two_stage=t, nprobe=4)
        for a, b in zip(old, new):
            assert torch.equal(a, b)
    teng.publish()
    assert teng.last_publish_info["mode"] in ("delta", "republish")
    assert teng.device_counters()["arrivals"] == 8 * B


def test_rag_server_answers_every_ticket_like_the_reference():
    jc, tc, js, ts, rng = _start("fp32", seed=2)
    jeng = JEngine(jc, jax.random.key(2), state=js)
    jsrv = JServer(jc, JServerConfig(max_batch=8, topk=5, two_stage=True,
                                     nprobe=4), engine=jeng)
    tsrv = TServer(tc, TServerConfig(max_batch=8, topk=5, two_stage=True,
                                     nprobe=4), engine=TEngine(tc, state=ts))
    jans, tans = [], []
    for step in range(6):
        x, ids = _batch(rng, step, False)
        tsrv.ingest(x, ids, draws=ingest_draws(jeng.state, B, jc.hh.bmax()))
        jsrv.ingest(x, ids)
        for qv in rng.normal(size=(5, D)).astype(np.float32):
            assert jsrv.submit(qv) == tsrv.submit(qv)
        if step % 2:
            jans += jsrv.flush()
            tans += tsrv.flush()
    jans += jsrv.drain()
    tans += tsrv.drain()
    assert sorted(a["ticket"] for a in tans) == list(range(30))
    assert tsrv.stats["queries"] == 30 and tsrv.stats["docs"] == 6 * B
    jby = {a["ticket"]: a for a in jans}
    for a in tans:
        ref = jby[a["ticket"]]
        np.testing.assert_array_equal(a["doc_ids"], np.asarray(ref["doc_ids"]))
        np.testing.assert_array_equal(a["clusters"], np.asarray(ref["clusters"]))
        np.testing.assert_allclose(a["scores"], np.asarray(ref["scores"]),
                                   rtol=1e-5, atol=1e-6)
    assert tsrv.latency_stats()["batches"] == jsrv.latency_stats()["batches"]


def test_budget_and_memory_accounting_match():
    for depth, dt in ((64, "int8"), (16, "fp32"), (0, "fp32")):
        jcfg = jpipe.budget_to_config(150.0, 384, j_config(store_depth=depth,
                                                           store_dtype=dt))
        tcfg = tpipe.budget_to_config(150.0, 384, t_config(store_depth=depth,
                                                           store_dtype=dt))
        assert tcfg.clus.num_clusters == jcfg.clus.num_clusters
        assert tcfg.hh.capacity == jcfg.hh.capacity
        assert tpipe.state_memory_bytes(tcfg) == jpipe.state_memory_bytes(jcfg)
    big = tpipe.budget_to_config(150.0, 384, t_config(store_depth=64,
                                                      store_dtype="int8"))
    assert big.clus.num_clusters == big.hh.capacity == 4218
