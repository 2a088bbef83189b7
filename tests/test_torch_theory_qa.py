"""The port's retrieval bound (``core/theory.py``), the two-shard centroid
merge and Δ (``core/clustering.py``) and the fact-stream QA workload
(``data/qa.py``) against the JAX package's on the CPU, and the
reference's own invariants of them run on the port.

Tolerances: decisions (labels, booleans, strings, every QA answer and
metric) exact; floats within rtol 1e-5 / atol 1e-6.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core import clustering as JC, theory as JT
from repro.data import qa as JQ
from repro.data.streams import make_stream as j_make_stream
from repro_torch.configs.streaming_rag import paper_pipeline_config
from repro_torch.core import baselines as TB, clustering as TC, pipeline, theory as TT
from repro_torch.data import qa as TQ
from repro_torch.data.streams import make_stream

RT, AT = 1e-5, 1e-6


def _mix(rng, n, d=32, T=4, noise=0.1):
    m = rng.normal(size=(T, d))
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    t = rng.integers(0, T, n)
    eps = rng.normal(size=(n, d))
    eps /= np.linalg.norm(eps, axis=1, keepdims=True)
    return (m[t] * (1 - noise) + noise * eps).astype(np.float32), t, m


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RT, atol=AT)


# ---------------------------------------------------------------- clustering
def test_merge_and_variance_match_reference():
    """Counts with clusters empty on one shard, on both (0.5 (a + b)) and
    on neither; Δ over assigned labels."""
    rng = np.random.default_rng(0)
    ca, cb = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    na = np.array([3, 0, 0, 5, 1, 0], np.float32)
    nb = np.array([1, 2, 0, 0, 4, 0], np.float32)
    jm = JC.merge(JC.ClusterState(jnp.asarray(ca), jnp.asarray(na)),
                  JC.ClusterState(jnp.asarray(cb), jnp.asarray(nb)))
    tm = TC.merge(TC.ClusterState(torch.from_numpy(ca), torch.from_numpy(na)),
                  TC.ClusterState(torch.from_numpy(cb), torch.from_numpy(nb)))
    _close(tm.centroids, jm.centroids)
    _close(tm.counts, jm.counts)
    _close(tm.centroids[[2, 5]], 0.5 * (ca[[2, 5]] + cb[[2, 5]]))
    x = rng.normal(size=(40, 16)).astype(np.float32)
    lbl = rng.integers(0, 6, 40).astype(np.int32)
    _close(TC.within_cluster_variance(tm, torch.from_numpy(x), torch.from_numpy(lbl)),
           JC.within_cluster_variance(jm, jnp.asarray(x), jnp.asarray(lbl)))


def test_merge_is_count_weighted():
    a = TC.ClusterState(torch.ones((2, 4)), torch.tensor([3.0, 0.0]))
    b = TC.ClusterState(torch.zeros((2, 4)), torch.tensor([1.0, 0.0]))
    m = TC.merge(a, b)
    np.testing.assert_allclose(m.centroids[0].numpy(), 0.75)
    assert float(m.counts[0]) == 4.0


def test_streaming_reduces_within_cluster_variance():
    rng = np.random.default_rng(1)
    cfg = TC.ClusterConfig(num_clusters=8, dim=32)
    state = TC.init(cfg, torch.Generator().manual_seed(1))
    x0 = torch.from_numpy(_mix(rng, 256)[0])
    l0, _ = TC.assign(cfg, state, x0)
    v_before = float(TC.within_cluster_variance(state, x0, l0))
    for _ in range(20):
        xb = torch.from_numpy(_mix(rng, 128)[0])
        lb, _ = TC.assign(cfg, state, xb)
        state = TC.update(cfg, state, xb, lb, torch.ones(128, dtype=torch.bool))
    l1, _ = TC.assign(cfg, state, x0)
    assert float(TC.within_cluster_variance(state, x0, l1)) < v_before


def test_kmeans_pp_spreads_centroids():
    rng = np.random.default_rng(2)
    x, _, m = _mix(rng, 512, T=4, noise=0.05)
    c = TC.kmeans_plus_plus(torch.Generator().manual_seed(0), torch.from_numpy(x), 8)
    assert ((c.numpy() @ m.T).max(axis=0) > 0.9).all()


# -------------------------------------------------------------------- theory
@pytest.mark.parametrize("with_valid", [False, True])
def test_check_bound_matches_reference(with_valid):
    rng = np.random.default_rng(4)
    corpus, _, m = _mix(rng, 200, d=24, T=5, noise=0.3)
    queries = (m[rng.integers(0, 5, 16)] + 0.05 * rng.normal(size=(16, 24))).astype(np.float32)
    cent = rng.normal(size=(7, 24)).astype(np.float32)
    labels = np.argmax(corpus @ cent.T, axis=1).astype(np.int32)
    valid = np.array([1, 1, 0, 1, 1, 0, 1], bool) if with_valid else None
    jr = JT.check_bound(jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(cent),
                        jnp.asarray(labels), None if valid is None else jnp.asarray(valid))
    tr = TT.check_bound(torch.from_numpy(queries), torch.from_numpy(corpus),
                        torch.from_numpy(cent), torch.from_numpy(labels),
                        None if valid is None else torch.from_numpy(valid))
    assert tr._fields == jr._fields
    for name in ("r_star", "r_proto", "delta", "bound_sqrt", "bound_linear"):
        _close(getattr(tr, name), getattr(jr, name))
    assert tr.lipschitz == jr.lipschitz == 1.0
    assert bool(tr.holds_sqrt) == bool(jr.holds_sqrt)
    assert bool(tr.holds_linear) == bool(jr.holds_linear)


@settings(max_examples=10, deadline=None)
@given(st.integers(2, 6), st.floats(0.05, 0.4))
def test_property_retrieval_bound(T, noise):
    """The reference's property on the port: after a few Lloyd rounds the
    proof-sketch (√Δ) form of the bound holds."""
    rng = np.random.default_rng(T)
    m = rng.normal(size=(T, 24))
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    t = rng.integers(0, T, 256)
    eps = rng.normal(size=(256, 24))
    eps /= np.linalg.norm(eps, axis=1, keepdims=True)
    corpus = torch.from_numpy((m[t] * (1 - noise) + noise * eps).astype(np.float32))
    queries = torch.from_numpy(m[rng.integers(0, T, 32)].astype(np.float32))
    cfg = TC.ClusterConfig(num_clusters=T, dim=24)
    state = TC.init_from_buffer(cfg, torch.Generator().manual_seed(0), corpus)
    for _ in range(5):
        lbl, _ = TC.assign(cfg, state, corpus)
        state = TC.update(cfg, state, corpus, lbl, torch.ones(256, dtype=torch.bool))
    lbl, _ = TC.assign(cfg, state, corpus)
    assert bool(TT.check_bound(queries, corpus, state.centroids, lbl).holds_sqrt)


def test_state_change_accounting():
    w, lb, ratio = TT.state_change_rate(torch.tensor(100, dtype=torch.int32),
                                        torch.tensor(10000, dtype=torch.int32))
    assert float(lb) == 100.0 and float(ratio) == 1.0
    for writes, n, p in ((7, 0, 2.0), (350, 4096, 3.0), (12, 5, 2.0)):
        got = TT.state_change_rate(torch.tensor(writes), torch.tensor(n), p)
        want = JT.state_change_rate(jnp.int32(writes), jnp.int32(n), p)
        for a, b in zip(got, want):
            _close(a, b)


# ------------------------------------------------------------------------ QA
def test_fact_stream_matches_reference():
    """Same base stream and seed: the same fact documents, ground truth,
    questions (embeddings included), reads and summaries."""
    jfs = JQ.FactStream(j_make_stream("btc", dim=32), n_entities=16, seed=0)
    tfs = TQ.FactStream(make_stream("btc", dim=32), n_entities=16, seed=0)
    for _ in range(6):
        jb, tb = jfs.next_batch(64), tfs.next_batch(64)
        for key in jb:
            np.testing.assert_array_equal(tb[key], jb[key])
    assert {i: dataclasses.asdict(d) for i, d in tfs.archive.items()} == \
        {i: dataclasses.asdict(d) for i, d in jfs.archive.items()}
    assert tfs.latest == jfs.latest
    jqs, tqs = jfs.qa_queries(10), tfs.qa_queries(10)
    assert len(tqs) == len(jqs) > 0
    ids = np.array(sorted(jfs.archive))
    rng = np.random.default_rng(0)
    for jq, tq in zip(jqs, tqs):
        assert {k: v for k, v in tq.items() if k != "embedding"} == \
            {k: v for k, v in jq.items() if k != "embedding"}
        np.testing.assert_array_equal(tq["embedding"], jq["embedding"])
        got = rng.choice(ids, 10)
        assert tfs.read(tq, got) == jfs.read(jq, got)
    for topic in range(4):
        got = rng.choice(ids, 40)
        assert tfs.summarize(topic, got) == jfs.summarize(topic, got)
        assert tfs.summary_reference(topic) == jfs.summary_reference(topic)


def test_metrics_match_reference():
    rng = np.random.default_rng(5)
    words = ["a", "b", "c", "value", "is", "3.1", ""]
    for _ in range(200):
        p = " ".join(rng.choice(words, rng.integers(0, 8)))
        r = " ".join(rng.choice(words, rng.integers(0, 8)))
        assert TQ.exact_match(p, r) == JQ.exact_match(p, r)
        assert TQ.token_f1(p, r) == JQ.token_f1(p, r)
        assert TQ.rouge_l(p, r) == JQ.rouge_l(p, r)


def test_exact_match_and_f1():
    assert TQ.exact_match("3.1", "3.1") == 1.0
    assert TQ.exact_match("3.1", "2.3") == 0.0
    assert TQ.exact_match("", "") == 0.0  # empty ref never counts
    assert TQ.token_f1("value is 3", "value is 4") == 2 / 3


def test_rouge_l_known_value():
    # LCS("a b c d", "a c d e") = "a c d" (3); P=3/4, R=3/4 -> F=0.75
    assert abs(TQ.rouge_l("a b c d", "a c d e") - 0.75) < 1e-9
    assert TQ.rouge_l("", "x") == 0.0


@settings(max_examples=30, deadline=None)
@given(st.lists(st.sampled_from("abcd"), min_size=1, max_size=12),
       st.lists(st.sampled_from("abcd"), min_size=1, max_size=12))
def test_property_rouge_l_matches_bruteforce_lcs(a, b):
    def lcs_len(x, y):
        best = 0
        for r in range(len(x) + 1):
            for sub in itertools.combinations(x, r):
                it = iter(y)
                if all(c in it for c in sub):
                    best = max(best, r)
        return best

    lcs = lcs_len(a, b)
    got = TQ.rouge_l(" ".join(a), " ".join(b))
    if lcs == 0:
        assert got == 0.0
    else:
        p, r = lcs / len(a), lcs / len(b)
        assert abs(got - 2 * p * r / (p + r)) < 1e-9


@settings(max_examples=30, deadline=None)
@given(st.text("abc xyz", max_size=20), st.text("abc xyz", max_size=20))
def test_property_f1_symmetric_bounded(a, b):
    f = TQ.token_f1(a, b)
    assert 0.0 <= f <= 1.0
    assert abs(f - TQ.token_f1(b, a)) < 1e-9


# ------------------------------------------------------------- the system
DIM = 48


def test_index_freshness_beats_static_snapshot():
    """The reference's case study on the port: fact values drift, and the
    streaming index answers newer values than a frozen snapshot."""
    fs = TQ.FactStream(make_stream("btc", dim=DIM), n_entities=24, seed=0)
    cfg = paper_pipeline_config(dim=DIM, k=64, capacity=48, update_interval=64,
                                alpha=0.0)
    warm = fs.next_batch(128)
    state = pipeline.init(cfg, 0, warm["embedding"], device="cpu")
    static = TB.make_static_rag(DIM, capacity=128)
    s_state = static.init(1, device="cpu")
    s_state = static.ingest(s_state, warm["embedding"], warm["doc_id"])
    for _ in range(20):
        b = fs.next_batch(128)
        state, _ = pipeline.ingest_batch(cfg, state, b["embedding"], b["doc_id"])
    em_stream, em_static = [], []
    for q in fs.qa_queries(20):
        qv = torch.from_numpy(q["embedding"])[None]
        _, _, ids, _ = pipeline.query(cfg, state, qv, 10)
        em_stream.append(TQ.exact_match(fs.read(q, ids.numpy()), q["answer"]))
        out = static.query(s_state, qv, 10)
        em_static.append(TQ.exact_match(fs.read(q, out[2].numpy()), q["answer"]))
    assert np.mean(em_stream) >= np.mean(em_static)
    assert np.mean(em_stream) > 0


def test_counter_state_change_optimality_accounting():
    """Writes stay near the heavy-hitter lower bound (Jayaram et al.)."""
    cfg = paper_pipeline_config(dim=DIM, k=64, capacity=32, update_interval=128,
                                alpha=0.1)
    stream = make_stream("twitter", dim=DIM)
    warm = np.concatenate([stream.next_batch(128)["embedding"] for _ in range(2)])
    state = pipeline.init(cfg, 0, warm, device="cpu")
    for _ in range(10):
        b = stream.next_batch(128)
        state, _ = pipeline.ingest_batch(cfg, state, b["embedding"], b["doc_id"])
    w, lb, ratio = TT.state_change_rate(state.hh.total_writes, state.hh.total_seen)
    assert float(w) <= float(state.hh.total_seen)
    assert float(ratio) < 50
