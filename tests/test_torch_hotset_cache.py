"""The port's hot-set serving cache (``tests/test_hotset_cache.py`` on
``repro_torch``: the two-level cache behind ``serve.runtime.AsyncServer``),
and the port's cached server held against the JAX package's.

* result cache exactness gates: a hit requires matching query bytes,
  plan bucket, snapshot version AND recorded routes — plus bounded LRU
  and precise publish invalidation (dirty-routed entries evicted, clean
  survivors re-keyed, no-dirty-info publishes clear).
* hot tier parity: a covered query served through the pinned tier
  (the serve path over the tier) is bit-identical to the full-store
  snapshot oracle after host remap.
* end-to-end bit-identity: a cached+hot AsyncServer and an uncached one
  sharing the SAME engine answer identically across rounds and across a
  dirtying publish; pin bytes are charged in ``state_memory_bytes``.
* constant stats schemas: latency/cache/freshness stats are zero-safe
  before the first flush and after ``close()``.
* against the JAX package: the same stream, the same counter draws and
  the same queries through both cached servers give the same tickets,
  versions, doc ids and clusters (scores within rtol 1e-5: the packages
  sum in other orders), equal ``cache_stats()`` and ``HotSet.stats()``;
  and the port's cached answers equal its own uncached ones bit for bit.

The 4-device sharded case is ROADMAP A8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs.streaming_rag import paper_pipeline_config as j_config
from repro.core import pipeline as jpipe
from repro.engine.engine import Engine as JEngine
from repro.serve.runtime import AsyncServer as JAsyncServer
from repro.serve.runtime import ServerConfig as JServerConfig
from repro_torch import convert
from repro_torch.configs.streaming_rag import paper_pipeline_config
from repro_torch.data.streams import make_stream
from repro_torch.core import index as index_lib
from repro_torch.engine import stages
from repro_torch.engine.engine import Engine
from repro_torch.serve.hotset import HotSet, route_signature
from repro_torch.serve.result_cache import ResultCache
from repro_torch.serve.runtime import AsyncServer, ServerConfig
from repro_torch.serve.server import RAGServer

from _torch_parity import ingest_draws, jax_tree

DIM = 32

pytestmark = pytest.mark.timeout(300)  # where pytest-timeout exists


def _reference_init_engine(cfg, seed):
    """A CPU engine on the state the reference's ``Engine(cfg, key(seed))``
    starts from (the packages draw their initial centroids differently)."""
    jcfg = j_config(dim=cfg.clus.dim, k=cfg.clus.num_clusters,
                    capacity=cfg.hh.capacity, alpha=cfg.pre.alpha,
                    admit_prob=cfg.hh.admit_prob,
                    update_interval=cfg.update_interval,
                    store_depth=cfg.store_depth, store_dtype=cfg.store_dtype)
    st = jpipe.init(jcfg, jax.random.key(seed))
    return Engine(cfg, state=convert.state_from_numpy(jax_tree(st), "cpu"))


def _cfg(**kw):
    return paper_pipeline_config(
        dim=DIM, k=kw.pop("k", 24), capacity=kw.pop("capacity", 24),
        alpha=0.1, admit_prob=1.0, update_interval=kw.pop(
            "update_interval", 64),
        store_depth=kw.pop("store_depth", 8), **kw)


# --------------------------------------------------------------- result cache
def test_result_cache_exactness_gates_and_lru():
    rc = ResultCache(2)
    routes = np.array([1, 5, -1], np.int32)
    ans = (np.ones(3, np.float32), np.arange(3, dtype=np.int32),
           np.arange(3, dtype=np.int32), np.zeros(3, np.int32))
    rc.insert(b"q0", "np4xd8", 3, routes, ans)
    assert rc.lookup(b"q0", "np4xd8", 3, routes) is ans
    # every gate misses independently: version, plan bucket, routes
    # (order matters — stage 1 emits an ORDERED route list), query bytes
    assert rc.lookup(b"q0", "np4xd8", 4, routes) is None
    assert rc.lookup(b"q0", "np2xd8", 3, routes) is None
    assert rc.lookup(b"q0", "np4xd8", 3,
                     np.array([5, 1, -1], np.int32)) is None
    assert rc.lookup(b"q1", "np4xd8", 3, routes) is None
    # bounded LRU: third distinct key evicts the oldest
    rc.insert(b"q1", "np4xd8", 3, routes, ans)
    rc.insert(b"q2", "np4xd8", 3, routes, ans)
    assert len(rc) == 2 and rc.evicted_lru == 1
    assert rc.lookup(b"q0", "np4xd8", 3, routes) is None
    s = rc.stats()
    assert s["hits"] == 1 and s["misses"] == 5 and s["entries"] == 2
    assert s["hit_rate"] == pytest.approx(1 / 6)


def test_result_cache_publish_invalidation_is_precise():
    rc = ResultCache(8)
    rc.insert(b"a", "p", 1, np.array([0, 3], np.int32), "A")
    rc.insert(b"b", "p", 1, np.array([4, 7], np.int32), "B")
    rc.insert(b"c", "p", 1, np.array([2, -1], np.int32), "C")
    rc.on_publish(2, np.array([3, 9]))     # dirties clusters {3, 9}
    # exactly the entry routed through 3 is gone; survivors re-keyed to
    # the new version and keep hitting there
    assert rc.invalidated == 1 and rc.rekeyed == 2 and len(rc) == 2
    assert rc.lookup(b"a", "p", 2, np.array([0, 3], np.int32)) is None
    assert rc.lookup(b"b", "p", 2, np.array([4, 7], np.int32)) == "B"
    assert rc.lookup(b"c", "p", 2, np.array([2, -1], np.int32)) == "C"
    # staleness: both hits survived exactly one publish
    assert rc.stats()["hit_staleness"] == pytest.approx(1.0)
    rc.on_publish(3, np.array([], np.int64))   # republish: nothing moved
    assert len(rc) == 2 and rc.rekeyed == 4 and rc.invalidated == 1
    rc.on_publish(4, None)                 # no dirty info -> clear all
    assert len(rc) == 0 and rc.cleared == 2
    assert rc.lookup(b"b", "p", 4, np.array([4, 7], np.int32)) is None


def test_result_cache_exact_peek_skips_route_verification():
    """Within one snapshot version routing is deterministic, so an entry
    verified at the pinned version answers without a route pass; a
    publish forces one verifying lookup before the fast path re-arms."""
    rc = ResultCache(4)
    routes = np.array([1, 2], np.int32)
    rc.insert(b"q", "p", 5, routes, "A")
    assert rc.peek_exact(b"q", "p", 5) == "A"
    assert rc.hits_exact == 1
    assert rc.peek_exact(b"q", "p", 6) is None     # version moved
    assert rc.misses == 0          # peek never counts a miss: the caller
    #                                falls through to the verifying lookup
    rc.on_publish(6, np.array([9]))                # clean -> rekeyed to 6
    assert rc.peek_exact(b"q", "p", 6) is None     # routes unverified at 6
    assert rc.lookup(b"q", "p", 6, routes) == "A"  # verifies routes at 6
    assert rc.peek_exact(b"q", "p", 6) == "A"      # fast path re-armed
    assert rc.stats()["hits_exact"] == 2


def test_route_witness_flags_near_ties():
    """The route pass is the serve path's own stage 1: its routes are the
    ones ``serve_topk`` serves through and ``stages.route`` gives, in
    their order, near-ties and exact ties included (an exact tie goes to
    the lowest slot), so no query is left unwitnessed; a lookup whose
    routes moved misses and counts it."""
    from repro_torch.kernels.common import l2_normalize_queries
    from repro_torch.kernels.serve.ref import serve_topk_ref

    d, cap, nprobe = 8, 6, 2
    cfg = index_lib.IndexConfig(capacity=cap, dim=d)
    e = np.eye(d, dtype=np.float32)
    # query 0: every score apart; query 1: rows 0 and 1 score exactly alike
    # (ranks 1 and 2); query 2: its 2nd and 3rd scores tie (the cut);
    # query 3: two scores 1 ulp apart
    vecs = np.stack([e[0], e[1], e[2], e[3], e[4], e[5]])
    q = np.stack([4 * e[0] + 3 * e[1] + 2 * e[2] + e[3],
                  e[0] + e[1] + 0.5 * e[2],
                  3 * e[0] + e[1] + e[2],
                  e[4] + np.nextafter(np.float32(1), np.float32(2)) * e[5]
                  + 0.5 * e[0]]).astype(np.float32)
    idx = index_lib.upsert(cfg, index_lib.init(cfg, "cpu"),
                           torch.arange(cap), torch.from_numpy(vecs),
                           torch.arange(cap, dtype=torch.int32),
                           torch.ones(cap, dtype=torch.bool))
    labels = torch.arange(10, 10 + cap, dtype=torch.int32)
    qt = torch.from_numpy(q)

    def served_routes(index, icfg):
        qn = l2_normalize_queries(qt)
        qr = qn if icfg.normalize else qt
        embs = torch.zeros((16, 1, d))
        ids = torch.full((16, 1), -1, dtype=torch.int32)
        return serve_topk_ref(qr, qn, index.vectors, index.valid, labels,
                              embs, ids, 1, nprobe)[2].numpy()

    routes = stages.route_witnessed(cfg, idx, labels, qt, nprobe)
    np.testing.assert_array_equal(
        routes, stages.route(cfg, idx, labels, qt, nprobe).numpy())
    np.testing.assert_array_equal(routes, served_routes(idx, cfg))
    assert routes[:3].tolist() == [[10, 11], [10, 11], [10, 11]]
    assert sorted(routes[3].tolist()) == [14, 15]
    # every probe dead past the valid rows
    dead = idx._replace(valid=torch.tensor([True] + [False] * (cap - 1)))
    r1 = stages.route_witnessed(cfg, dead, labels, qt, nprobe)
    assert r1[:, 1].tolist() == [-1, -1, -1, -1]
    np.testing.assert_array_equal(r1, served_routes(dead, cfg))
    # an index that does not normalize routes the raw queries
    raw_cfg = index_lib.IndexConfig(capacity=cap, dim=d, normalize=False)
    raw = idx._replace(vectors=idx.vectors * 3)
    r2 = stages.route_witnessed(raw_cfg, raw, labels, qt, nprobe)
    np.testing.assert_array_equal(
        r2, stages.route(raw_cfg, raw, labels, qt, nprobe).numpy())
    np.testing.assert_array_equal(r2, served_routes(raw, raw_cfg))

    rc = ResultCache(4)
    rc.insert(b"q", "p", 1, np.array([10, 11], np.int32), "A")
    rc.on_publish(2, np.array([], np.int32))
    assert rc.lookup(b"q", "p", 2, np.array([11, 10], np.int32)) is None
    assert (rc.routes_moved, rc.misses) == (1, 1)
    assert rc.lookup(b"q", "p", 2, np.array([10, 11], np.int32)) == "A"


def test_route_signature_is_order_invariant_and_pad_inert():
    a = np.array([7, 2, 11, -1], np.int32)
    b = np.array([11, 7, 2, -1, -1, -1], np.int32)
    assert route_signature(a) == route_signature(b) >= 0
    assert route_signature(np.array([-1, -1], np.int32)) == -1
    assert route_signature(a) != route_signature(np.array([7, 2], np.int32))


# ------------------------------------------------------------ hot tier parity
def test_hot_tier_serve_is_bit_identical_to_snapshot_oracle():
    cfg = _cfg(k=16, capacity=16, store_depth=4, update_interval=32)
    eng = _reference_init_engine(cfg, 1)
    stream = make_stream("iot", dim=DIM)
    for _ in range(6):
        b = stream.next_batch(32)
        eng.ingest(b["embedding"], b["doc_id"])
    snap = eng.publish()

    hs = HotSet(cfg, max_batch=8, pin_budget_bytes=1 << 20, capacity=16,
                refresh_every=1, min_count=1, device="cpu")
    q = np.asarray(stream.queries(8)["embedding"], np.float32)
    routes = stages.route(cfg.index, snap.index, snap.route_labels,
                          torch.from_numpy(q), 4).numpy()
    hs.observe(routes)
    hs.sync(snap)
    assert hs.active and hs.pinned_bytes > 0
    cov = hs.covered(routes)
    # budget >> store: every routed cluster of every observed query pins
    assert cov.all()

    out = [a.numpy() for a in hs.serve(snap, torch.from_numpy(q), 5, 4,
                                       cfg.store_depth)]
    rows, clusters = hs.remap(out[1], out[3])
    np.testing.assert_array_equal(hs.remap_routes(out[4]), routes)
    want = [a.numpy() for a in
            eng.query_snapshot(snap, q, 5, two_stage=True, nprobe=4)]
    np.testing.assert_array_equal(out[0], want[0])
    np.testing.assert_array_equal(rows, want[1])
    np.testing.assert_array_equal(out[2], want[2])
    np.testing.assert_array_equal(clusters, want[3])


@pytest.mark.parametrize("depth", [None, 2])
def test_tier_serve_returns_its_answer_decoded_in_tier_coordinates(depth):
    """Over a hot tier (16 pinned rings, the last ones padding) and its
    remapped labels, ``routed_query``'s one serve call returns the answer
    decoded in tier coordinates: the plain version's picks over the tier
    followed by ``stages.decode_rerank`` over the tier's ids, at the full
    depth and at a clipped plan (rows at the store's depth)."""
    from repro_torch.engine.engine import routed_query
    from repro_torch.kernels.common import l2_normalize_queries
    from repro_torch.kernels.serve.ref import serve_topk_ref

    cfg = _cfg(k=24, capacity=24, store_depth=4, update_interval=32)
    eng = _reference_init_engine(cfg, 2)
    stream = make_stream("iot", dim=DIM)
    for _ in range(6):
        b = stream.next_batch(32)
        eng.ingest(b["embedding"], b["doc_id"])
    snap = eng.publish()
    q = torch.from_numpy(np.asarray(stream.queries(8)["embedding"], np.float32))
    routes = stages.route(cfg.index, snap.index, snap.route_labels, q, 4).numpy()
    pinned = sorted(set(routes[routes >= 0].tolist()))[:12]
    H, n = 16, len(pinned)
    clusters = np.zeros(H, np.int32)
    clusters[:n] = pinned
    tier = stages.gather_rings(snap.store, torch.from_numpy(clusters),
                               torch.from_numpy(np.arange(H) < n))
    c2s = np.full(cfg.clus.num_clusters, -1, np.int32)
    c2s[pinned] = np.arange(n, dtype=np.int32)
    lab = snap.route_labels.numpy()
    hot = torch.from_numpy(np.where(lab >= 0, c2s[np.maximum(lab, 0)], -1).astype(np.int32))

    got = routed_query(cfg, snap.index, hot, tier, q, 5, 4, depth)
    dv = cfg.store_depth if depth is None else depth
    qn = l2_normalize_queries(q)
    qr = qn if cfg.index.normalize else q
    scales = tier.scales[:, :dv] if tier.embs.dtype == torch.int8 else None
    sc, pos, rt = serve_topk_ref(qr, qn, snap.index.vectors, snap.index.valid, hot,
                                 tier.embs[:, :dv], tier.ids[:, :dv], 5, 4, scales)[:3]
    want = stages.decode_rerank(tier.ids, rt, sc, pos, dv, 4, store_depth=cfg.store_depth)
    for a, b in zip(got, want + (rt,)):
        assert torch.equal(a, b)
    live = got[3] >= 0
    assert bool(live.any()) and int(got[3].max()) < n
    assert torch.equal(got[1][live] // cfg.store_depth, got[3][live])


# ----------------------------------------------------------------- end to end
def test_cached_server_bit_identical_to_uncached_across_publishes():
    """A cached+hot server and an uncached one over the SAME engine give
    identical answers round after round, including straight through a
    dirtying publish — and the cache actually worked (hits, hot serving,
    tier rebuilds, precise invalidation all observed)."""
    cfg = _cfg()
    stream = make_stream("iot", dim=DIM)
    eng = _reference_init_engine(cfg, 0)
    srv = AsyncServer(
        cfg, ServerConfig(max_batch=8, max_wait_ms=0.0, topk=5,
                          two_stage=True, nprobe=4, cache_entries=64,
                          hotset=True, pin_budget_mb=1.0, hotset_refresh=2,
                          hotset_min_count=1),
        engine=eng, publish_every=1)
    srv_u = AsyncServer(
        cfg, ServerConfig(max_batch=8, max_wait_ms=0.0, topk=5,
                          two_stage=True, nprobe=4),
        engine=eng, publish_every=10**9)
    for _ in range(4):
        b = stream.next_batch(32)
        srv.ingest(b["embedding"], b["doc_id"])
    srv.sync()
    srv_u.sync()   # both pin snapshots of identical engine content

    pool = np.asarray(stream.queries(12)["embedding"], np.float32)
    rng = np.random.default_rng(3)
    for rnd in range(6):
        if rnd == 3:   # dirtying publish mid-run; re-pin both servers
            b = stream.next_batch(32)
            srv.ingest(b["embedding"], b["doc_id"])
            srv.sync()
            srv_u.sync()
        qs = pool[rng.integers(0, len(pool), 8)]
        tc = [srv.submit(qv) for qv in qs]
        tu = [srv_u.submit(qv) for qv in qs]
        out_c = {o["ticket"]: o for o in srv.flush()}
        out_u = {o["ticket"]: o for o in srv_u.flush()}
        assert len(out_c) == len(out_u) == 8
        for a, b_ in zip(tc, tu):
            np.testing.assert_array_equal(out_c[a]["scores"],
                                          out_u[b_]["scores"])
            np.testing.assert_array_equal(out_c[a]["doc_ids"],
                                          out_u[b_]["doc_ids"])
            np.testing.assert_array_equal(out_c[a]["clusters"],
                                          out_u[b_]["clusters"])

    cs = srv.cache_stats()
    assert cs["enabled"]
    assert cs["hits"] > 0 and 0.0 < cs["hit_rate"] < 1.0
    assert cs["hot_served"] > 0 and cs["tier_rebuilds"] > 0
    # the mid-run publish actually exercised invalidation
    assert cs["invalidated"] + cs["cleared"] > 0
    assert cs["hit_staleness"] >= 0.0
    # pin accounting: resident tier bytes charged on top of engine state
    assert cs["pinned_bytes"] > 0
    assert srv.state_memory_bytes() == \
        eng.state_memory_bytes() + cs["pinned_bytes"]
    ls = srv.latency_stats()
    assert ls["pinned_bytes"] == cs["pinned_bytes"]
    assert ls["cache_hit_rate"] == pytest.approx(cs["hit_rate"])
    assert srv.route_mismatches == 0
    srv.close()
    srv_u.close()


def test_cached_server_route_checked_hits_after_a_clean_publish():
    """A publish that moves no cluster (a batch of padding rows) keeps
    every entry, re-keyed to the new version; the next flush of the same
    queries answers them from the cache through the route check, not the
    route-free path, and equals the uncached server on the new snapshot
    bit for bit."""
    cfg = _cfg()
    stream = make_stream("iot", dim=DIM)
    eng = _reference_init_engine(cfg, 0)
    scfg = dict(max_batch=8, max_wait_ms=0.0, topk=5, two_stage=True, nprobe=4)
    srv = AsyncServer(cfg, ServerConfig(**scfg, cache_entries=64, hotset=True,
                                        pin_budget_mb=1.0, hotset_refresh=2,
                                        hotset_min_count=1),
                      engine=eng, publish_every=1)
    srv_u = AsyncServer(cfg, ServerConfig(**scfg), engine=eng,
                        publish_every=10**9)
    for _ in range(4):
        b = stream.next_batch(32)
        srv.ingest(b["embedding"], b["doc_id"])
    srv.sync(timeout=120)
    qs = np.asarray(stream.queries(8)["embedding"], np.float32)

    def both():
        tc = [srv.submit(qv) for qv in qs]
        tu = [srv_u.submit(qv) for qv in qs]
        out_c = {o["ticket"]: o for o in srv.flush()}
        out_u = {o["ticket"]: o for o in srv_u.flush()}
        for a, b_ in zip(tc, tu):   # both pin snapshots of one engine state
            for key in ("scores", "doc_ids", "clusters"):
                np.testing.assert_array_equal(out_c[a][key], out_u[b_][key])

    srv_u.sync(timeout=120)
    both()                                  # misses: computed and inserted
    before = srv._result_cache.stats()
    b = stream.next_batch(32)
    srv.ingest(b["embedding"], np.full_like(b["doc_id"], -1))
    srv.sync(timeout=120)
    srv_u.sync(timeout=120)
    assert eng.last_publish_info["mode"] == "republish"
    both()
    cs = srv._result_cache.stats()
    route_checked = ((cs["hits"] - cs["hits_exact"])
                     - (before["hits"] - before["hits_exact"]))
    assert cs["rekeyed"] > before["rekeyed"]
    assert route_checked == cs["entries"] > 0
    assert cs["hit_staleness"] > 0.0
    assert srv.route_mismatches == 0 and srv.route_near_ties == 0
    srv.close(timeout=120)
    srv_u.close(timeout=120)


# -------------------------------------------------------------- stats schemas
def test_stats_schemas_constant_before_first_flush_and_after_close():
    cfg = _cfg()
    srv = AsyncServer(
        cfg, ServerConfig(max_batch=4, max_wait_ms=0.0, topk=5,
                          two_stage=True, nprobe=4, cache_entries=8,
                          hotset=True, pin_budget_mb=0.25),
        seed=2, device="cpu")
    cache_keys = {"enabled", "hits", "misses", "hit_rate", "entries",
                  "invalidated", "cleared", "rekeyed", "evicted_lru",
                  "hit_staleness", "pinned_bytes", "pinned_clusters",
                  "hot_served", "tier_rebuilds"}

    def check(server):
        ls = server.latency_stats()
        assert ls["cache_hit_rate"] == 0.0 and ls["pinned_bytes"] == 0
        assert ls["batches"] == 0 and ls["p50_ms"] == 0.0
        cs = server.cache_stats()
        assert set(cs) == cache_keys and cs["enabled"]
        assert cs["hits"] == cs["misses"] == 0 and cs["hit_rate"] == 0.0
        fr = server.freshness_stats()
        assert {"snapshot_version", "published_at", "snapshot_age_s",
                "docs_enqueued", "docs_ingested", "docs_published",
                "lag_docs"} <= set(fr)
        assert fr["lag_docs"] == 0

    check(srv)           # before any flush or publish-cadence tick
    srv.close()
    check(srv)           # after close: same schema, still zero-safe
    # caching disabled -> same cache_stats schema, enabled=False
    plain = AsyncServer(
        cfg, ServerConfig(max_batch=4, max_wait_ms=0.0, topk=5,
                          two_stage=True, nprobe=4),
        seed=2, device="cpu")
    cs = plain.cache_stats()
    assert set(cs) == cache_keys and not cs["enabled"]
    plain.close()


def test_cache_config_guardrails():
    cfg = _cfg()
    # caching requires two_stage (answers must record routed clusters)
    with pytest.raises(AssertionError, match="two_stage"):
        AsyncServer(cfg, ServerConfig(max_batch=4, topk=5,
                                      cache_entries=8),
                    seed=0, device="cpu")
    # ...and the snapshot runtime: the sync server queries live state,
    # which has no publish boundary to invalidate against
    with pytest.raises(AssertionError, match="snapshot runtime"):
        RAGServer(cfg, ServerConfig(max_batch=4, topk=5, two_stage=True,
                                    nprobe=4, hotset=True),
                  seed=0, device="cpu")


# -------------------------------------------------------- against the JAX one
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


PKW = dict(dim=DIM, k=24, capacity=24, store_depth=8, update_interval=64,
           alpha=0.1, admit_prob=0.5)
T = 60.0


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_cached_server_matches_reference(store_dtype):
    """The port's cached + hot AsyncServer against the JAX one: the same
    state, the same batches (the port fed the reference's counter draws),
    the same Zipf-repeated queries across dirtying publishes."""
    B = 32
    jc = j_config(store_dtype=store_dtype, **PKW)
    tc = paper_pipeline_config(store_dtype=store_dtype, **PKW)
    rng = np.random.default_rng(21)
    warm = rng.normal(size=(64, DIM)).astype(np.float32)
    js = jpipe.init(jc, jax.random.key(21), jnp.asarray(warm))
    jeng = JEngine(jc, jax.random.key(21), state=js)
    teng = _RecordingEngine(tc, state=convert.state_from_numpy(jax_tree(js),
                                                              "cpu"))
    sc = dict(max_batch=8, max_wait_ms=0.0, topk=5, two_stage=True,
              nprobe=4, cache_entries=12, hotset=True, pin_budget_mb=0.05,
              hotset_capacity=8, hotset_refresh=2, hotset_min_count=2)
    jobs.disable()
    jobs.enable(trace=False)
    jsrv = JAsyncServer(jc, JServerConfig(**sc), engine=jeng,
                        publish_every=1)
    tsrv = AsyncServer(tc, ServerConfig(**sc), engine=teng, publish_every=1)
    pool = rng.normal(size=(16, DIM)).astype(np.float32)
    zipf = np.minimum(rng.zipf(1.3, size=400) - 1, len(pool) - 1)
    draw = iter(zipf)
    try:
        for step in range(6):
            x = rng.normal(size=(B, DIM)).astype(np.float32)
            ids = np.arange(step * B, (step + 1) * B, dtype=np.int32)
            if step % 2:
                ids[-3:] = -1
            draws = ingest_draws(jeng.state, B, jc.hh.bmax())
            jsrv.ingest(x, ids)
            tsrv.ingest(x, ids, draws=draws)
            jsrv.sync(timeout=T)
            tsrv.sync(timeout=T)
            for _ in range(3):
                qs = pool[[next(draw) for _ in range(8)]]
                tick = [(jsrv.submit(qv), tsrv.submit(qv)) for qv in qs]
                ja = {o["ticket"]: o for o in jsrv.flush()}
                ta = {o["ticket"]: o for o in tsrv.flush()}
                for (jt, tt), qv in zip(tick, qs):
                    assert jt == tt
                    j, t = ja[jt], ta[tt]
                    assert t["snapshot_version"] == j["snapshot_version"]
                    np.testing.assert_array_equal(t["doc_ids"], j["doc_ids"])
                    np.testing.assert_array_equal(t["clusters"],
                                                  j["clusters"])
                    np.testing.assert_allclose(t["scores"], j["scores"],
                                               rtol=1e-5, atol=1e-6)
                    # the port's uncached answer: its snapshot, served alone
                    snap = teng.published[t["snapshot_version"]]
                    want = teng.query_snapshot(snap, qv[None], 5,
                                               two_stage=True, nprobe=4)
                    for key, w in zip(("scores", "doc_ids", "clusters"),
                                      (want[0], want[2], want[3])):
                        np.testing.assert_array_equal(t[key], w[0].numpy())
        # the reference's HotSet counts the rows it serves after padding
        # them to a power of two; its hotset_served_total counts the real
        # rows, as the port's HotSet does (ROADMAP C0c)
        real = jobs.metrics().counter("hotset_served_total").value
        assert jsrv.cache_stats()["hot_served"] >= real
        for got, want in ((tsrv.cache_stats(), jsrv.cache_stats()),
                          (tsrv._hotset.stats(), jsrv._hotset.stats())):
            assert got == {**want, "hot_served": real}
        cs = tsrv.cache_stats()
        assert cs["hits"] > 0 and cs["hot_served"] > 0
        assert cs["tier_rebuilds"] > 0 and cs["invalidated"] > 0
        assert tsrv.latency_stats()["pinned_bytes"] == \
            jsrv.latency_stats()["pinned_bytes"] > 0
        assert tsrv.state_memory_bytes() == jsrv.state_memory_bytes()
        assert tsrv.route_mismatches == 0
    finally:
        jsrv.close()
        tsrv.close()
        jobs.disable()


def test_route_signatures_equal_the_reference():
    from repro.serve import hotset as jhotset

    rng = np.random.default_rng(4)
    for _ in range(50):
        row = rng.integers(-1, 4218, size=8).astype(np.int32)
        assert route_signature(row) == jhotset.route_signature(row)
    cfg = paper_pipeline_config(dim=384, k=4218, capacity=4218,
                                store_depth=64, store_dtype="int8")
    jcfg = j_config(dim=384, k=4218, capacity=4218, store_depth=64,
                    store_dtype="int8")
    from repro_torch.serve.hotset import per_cluster_bytes
    assert per_cluster_bytes(cfg.store) == \
        jhotset.per_cluster_bytes(jcfg.store) == 25_348
