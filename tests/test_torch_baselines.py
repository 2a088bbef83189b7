"""The port's eight comparison methods (``repro_torch.core.baselines``)
against the JAX package's, on the CPU.

Each method starts from the reference's own state (carried by
``convert.baseline_state_from_numpy``) or, where it trains, from the
reference's own draws; both packages then ingest the same batches of a
seeded stream, the port fed every random draw the reference makes
(reservoir join uniforms and slots, full rebuild's k-means++ rows, the
counters' draws; ``_torch_parity``). After every batch the whole state
is held leaf for leaf, and after every few the answers to a round of
queries.

Tolerances: integer and bool leaves, ids and rows exact; float leaves and
scores within rtol 1e-5 / atol 1e-6 (``assert_trees``: the packages sum
in other orders). One decision is a tie by construction: full rebuild's
representative of a cluster of two documents (the centroid is their
mean, to which both have the same cosine), which the last bit of each
package's product decides. There a slot's doc id may differ, only where
both documents score within 1e-6 of each other against the reference's
centroid (ROADMAP's near-tie rule); every other leaf stays exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.streaming_rag import paper_pipeline_config as j_config
from repro.core import baselines as JB
from repro.data.streams import make_stream
from repro_torch import convert
from repro_torch.configs.streaming_rag import paper_pipeline_config as t_config
from repro_torch.core import baselines as TB

from _torch_parity import (assert_trees, hh_draws, ingest_draws, jax_tree,
                           kmeanspp_picks, reservoir_draws)

D, B, Q, K = 32, 48, 12, 8
PIPE = dict(dim=D, k=24, capacity=16, update_interval=64, alpha=0.1)


def _makers(mod, config):
    """name -> Method at small sizes (the tables' shapes, scaled down)."""
    cfg = config(**PIPE)
    cfg2 = config(store_depth=4, **PIPE)
    return {
        "static_rag": lambda: mod.make_static_rag(D, capacity=128),
        "full_rebuild": lambda: mod.make_full_rebuild(D, buffer_size=128, k=16,
                                                      rebuild_interval=64),
        "reservoir": lambda: mod.make_reservoir(D, k=32),
        "heap_only": lambda: mod.make_heap_only(D, n_anchors=32, capacity=16,
                                                admit_prob=0.5),
        "ivfpq_incremental": lambda: mod.make_ivfpq(D, capacity=128, nlist=8, m=4,
                                                    nprobe=2),
        "sakr": lambda: mod.make_sakr(D, k=16, capacity=16),
        "streaming_rag": lambda: mod.make_streaming_rag(cfg),
        "streaming_rag_2stage": lambda: mod.make_streaming_rag_two_stage(cfg2, nprobe=4),
    }


PIPELINES = ("sakr", "streaming_rag", "streaming_rag_2stage")


def _draws(name, jm, js, x):
    """The draws the reference's ingest of ``x`` makes from its state, as
    the port takes them (None where the method draws nothing)."""
    n = x.shape[0]
    if name == "reservoir":
        return reservoir_draws(js.rng, n, int(js.index.vectors.shape[0]))
    if name == "heap_only":
        _, kh = jax.random.split(js.rng)
        return hh_draws(kh, n, int(js.hh.labels.shape[0]))
    if name in PIPELINES:
        return ingest_draws(js, n, int(js.hh.labels.shape[0]))
    return None


def _rebuild_draws(jm, js, js_next, x):
    """Full rebuild: the k-means++ rows of the rebuild this batch ran (over
    the buffer after its write), or None when it ran none."""
    if int(js_next.since) != 0:
        return None
    _, kk = jax.random.split(js.rng)
    k = int(js_next.index.vectors.shape[0])
    return {"picks": kmeanspp_picks(kk, np.asarray(js_next.buf), k)}


def _rebuild_tie_swaps(js, ts) -> dict:
    """Full rebuild's slots whose doc id differs, each checked to be a
    near-tie (both documents members of the slot's cluster, scoring within
    1e-6 of each other against the reference's centroid): port id ->
    reference id."""
    want, got = np.asarray(js.index.ids), ts.index.ids.numpy()
    buf = np.asarray(js.buf, np.float64)
    xn = buf / np.maximum(np.linalg.norm(buf, axis=1, keepdims=True), 1e-12)
    c = np.asarray(js.index.vectors, np.float64)
    lbl, bid = np.argmax(xn @ c.T, axis=1), np.asarray(js.buf_ids)
    swaps = {}
    for j in np.nonzero(want != got)[0]:
        a, b = np.nonzero(bid == want[j])[0], np.nonzero(bid == got[j])[0]
        assert a.size == b.size == 1 and lbl[a[0]] == lbl[b[0]] == j, (j, want[j], got[j])
        assert abs(xn[a[0]] @ c[j] - xn[b[0]] @ c[j]) < 1e-6, (j, want[j], got[j])
        swaps[int(got[j])] = int(want[j])
    return swaps


def _start(name, jm, tm, stream):
    key = jax.random.key(0)
    warm = np.concatenate([stream.next_batch(B)["embedding"] for _ in range(2)])
    if name == "ivfpq_incremental":
        from _torch_parity import ivfpq_train_draws

        js = jm.init(key, jnp.asarray(warm))
        draws = ivfpq_train_draws(key, warm, 8, 4)
        ts = tm.init(0, warm, device="cpu", draws=draws)
        assert_trees(jax_tree(js), convert.state_to_numpy(ts))
        return js, ts
    js = jm.init(key, jnp.asarray(warm)) if name in PIPELINES else jm.init(key)
    return js, convert.baseline_state_from_numpy(name, jax_tree(js), "cpu")


def _assert_answers(jout, tout, where, swaps=None):
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=1e-5,
                               atol=1e-6, err_msg=where)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]), err_msg=where)
    ids = tout[2].numpy()
    if swaps:
        ids = np.vectorize(lambda i: swaps.get(int(i), int(i)))(ids)
    np.testing.assert_array_equal(ids, np.asarray(jout[2]), err_msg=where)


def _replay(name, batches, queries=(), probe_every=2):
    jm, tm = _makers(JB, j_config)[name](), _makers(TB, t_config)[name]()
    assert jm.name == tm.name == name
    assert jm.memory_bytes() == tm.memory_bytes()
    stream = make_stream("nyt", dim=D)
    js, ts = _start(name, jm, tm, stream)
    for step, (x, ids) in enumerate(batches):
        draws = _draws(name, jm, js, x)
        js_next = jm.ingest(js, jnp.asarray(x), jnp.asarray(ids))
        if name == "full_rebuild":
            draws = _rebuild_draws(jm, js, js_next, x)
        ts = tm.ingest(ts, x, ids, draws=draws)
        js = js_next
        got = convert.state_to_numpy(ts)
        swaps = _rebuild_tie_swaps(js, ts) if name == "full_rebuild" else {}
        if swaps:
            got["index"]["ids"] = np.vectorize(lambda i: swaps.get(int(i), int(i)))(
                got["index"]["ids"]).astype(np.int32)
        assert_trees(jax_tree(js), got, path=f"step {step}: ")
        if queries is not None and (step + 1) % probe_every == 0:
            q = queries[step // probe_every]
            _assert_answers(jm.query(js, jnp.asarray(q), K), tm.query(ts, q, K),
                            f"{name} step {step}", swaps)
    return js, ts


def _stream_batches(n, batch=B, seed=5):
    s = make_stream("nyt", dim=D, seed=seed)
    out = []
    for i in range(n):
        b = s.next_batch(batch)
        out.append((b["embedding"], (1000 + i * batch + np.arange(batch)).astype(np.int32)))
    qs = [s.queries(Q)["embedding"] for _ in range(n)]
    return out, qs


@pytest.mark.parametrize("name", list(_makers(TB, t_config)))
def test_method_matches_reference(name):
    """Six batches of 48 (static RAG crosses its capacity of 128 and
    freezes; full rebuild rebuilds every 64 arrivals; the counters evict),
    a round of queries after every second batch."""
    batches, qs = _stream_batches(6)
    _replay(name, batches, qs)


def test_static_rag_crossing_capacity_tombstones_last_slot():
    """ROADMAP C0d: the reference clips a capacity-crossing batch onto the
    last slot, where its last row wins, tombstoned; the port reproduces it
    (capacity 8, batches of 6 and 5: doc 101 is lost)."""
    rng = np.random.default_rng(0)
    jm, tm = JB.make_static_rag(D, capacity=8), TB.make_static_rag(D, capacity=8)
    js = jm.init(jax.random.key(0))
    ts = tm.init(0, device="cpu")
    for ids in (np.arange(6, dtype=np.int32), np.arange(100, 105, dtype=np.int32),
                np.arange(200, 203, dtype=np.int32)):
        x = rng.normal(size=(len(ids), D)).astype(np.float32)
        js = jm.ingest(js, jnp.asarray(x), jnp.asarray(ids))
        ts = tm.ingest(ts, x, ids)
        assert_trees(jax_tree(js), convert.state_to_numpy(ts))
        if ids[0] == 100:
            assert ts.index.valid.tolist() == [True] * 7 + [False]
            assert ts.index.ids.tolist() == [0, 1, 2, 3, 4, 5, 100, -1]
    assert ts.frozen and ts.fill == 8 and ts.index.version == 3


def test_reservoir_slot_collisions_last_taker_wins():
    """A reservoir of 4 over batches of 64: many arrivals of one batch take
    the same slot, and the batch's single write keeps each slot's last
    taker, as the reference's per-arrival scan does."""
    rng = np.random.default_rng(1)
    jm, tm = JB.make_reservoir(D, k=4), TB.make_reservoir(D, k=4)
    js = jm.init(jax.random.key(3))
    ts = convert.baseline_state_from_numpy("reservoir", jax_tree(js), "cpu")
    most = 0
    for step in range(4):
        x = rng.normal(size=(64, D)).astype(np.float32)
        ids = (step * 64 + np.arange(64)).astype(np.int32)
        draws = reservoir_draws(js.rng, 64, 4)
        t = js.seen + 1 + np.arange(64)
        take = (draws["uniforms"].numpy() < np.float32(4) / t.astype(np.float32)) | (t <= 4)
        slot = np.where(t <= 4, t - 1, draws["slots"].numpy())
        most = max(most, np.bincount(slot[take], minlength=4).max())
        js = jm.ingest(js, jnp.asarray(x), jnp.asarray(ids))
        ts = tm.ingest(ts, x, ids, draws=draws)
        assert_trees(jax_tree(js), convert.state_to_numpy(ts))
    assert most >= 3, most


@pytest.mark.parametrize("name", ["heap_only", "full_rebuild"])
def test_exact_tie_in_a_batch_goes_to_its_last_row(name):
    """A document repeated inside a batch (rows 3, 30 and 41, other ids)
    ties exactly on its segment's best score: a copy of anchor 0 for
    heap-only, a direction far from the stream for full rebuild (the
    copies make a cluster of their own). The reference's scatter keeps
    the last copy, and so does the port."""
    batches, _ = _stream_batches(2, seed=7)
    if name == "heap_only":
        v = np.asarray(_makers(JB, j_config)[name]().init(jax.random.key(0)).anchors[0])
    else:
        v = np.random.default_rng(11).normal(size=D).astype(np.float32)
    x, ids = batches[1]
    x = x.copy()
    x[[3, 30, 41]] = v
    batches[1] = (x, ids)
    js, ts = _replay(name, batches, queries=None)
    got = ts.best_id.tolist() if name == "heap_only" else ts.index.ids.tolist()
    assert int(ids[41]) in got and int(ids[3]) not in got and int(ids[30]) not in got
