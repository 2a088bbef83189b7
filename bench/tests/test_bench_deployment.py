"""What a deployment file and a traffic file can say, and how the harness
reads it: the whole ``server`` block builds the server (the keys the
check cannot judge are refused before an engine is built), and the
query pool is drawn uniformly or, with ``zipf_s``, by rank with Zipf
skew."""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import pytest

from bench.tests import _tiny

REPO = _tiny.REPO


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("change,refused", [
    ({}, None),
    ({"max_batchh": 256}, "max_batchh"),
    ({"two_stage": False}, "two_stage"),
    ({"adaptive": True}, "adaptive"),
    ({"durability": True}, "durability"),
])
def test_build_takes_the_whole_server_block(monkeypatch, change, refused):
    """srag-4gb.json builds the server the harness built before it read the
    whole block; each refusal raises, naming its key, before an engine."""
    from repro_torch.engine import engine
    from repro_torch.serve import runtime

    from bench import system

    built = {}

    class Engine:
        def __init__(self, *a, **kw):
            built["engine"] = True

    class AsyncServer:
        def __init__(self, pcfg, scfg, engine, **kw):
            built.update(scfg=scfg, kw=kw)

    monkeypatch.setattr(engine, "Engine", Engine)
    monkeypatch.setattr(runtime, "AsyncServer", AsyncServer)
    cfg = json.loads((REPO / "bench/configs/srag-4gb.json").read_text())
    cfg["server"].update(change)
    if refused is not None:
        with pytest.raises(ValueError, match=repr(refused)):
            system.build(cfg, 1, None, "cpu")
        assert built == {}
        return
    _, pcfg = system.build(cfg, 1, None, "cpu")
    assert built["engine"] and pcfg.clus.num_clusters == 112501
    # the ServerConfig and AsyncServer arguments the harness built before
    today = runtime.ServerConfig(max_batch=256, max_wait_ms=2.0, topk=10,
                                 two_stage=True, nprobe=16)

    def typed(c):
        return {k: (type(v), v) for k, v in dataclasses.asdict(c).items()}
    assert typed(built["scfg"]) == typed(today)
    assert built["kw"] == {"publish_every": 4, "queue_max": 16}


def test_build_passes_each_key_to_its_field():
    from repro_torch.serve import runtime

    from bench import system

    s = {"two_stage": True, "nprobe": 4, "topk": 5, "max_batch": 32,
         "max_wait_ms": 1, "cache_entries": 24, "hotset": True,
         "pin_budget_mb": 0.5, "hotset_capacity": 64, "hotset_refresh": 8,
         "hotset_min_count": 3, "publish_every": 1, "queue_max": 8,
         "adaptive": False, "durability": False}
    scfg, kw = system.server_args(s)
    got = runtime.ServerConfig(**scfg)
    for key in system.CONFIG_KEYS:
        assert getattr(got, key) == s[key], key
    assert got.max_wait_ms == 1.0 and type(got.max_wait_ms) is float
    assert kw == {"publish_every": 1, "queue_max": 8}
    with pytest.raises(ValueError, match="'hotset'"):
        system.server_args({**s, "hotset": "yes"})


# today's draws (from the code before ``zipf_s`` existed) at the test copy's
# tiny.query over 0.5 s: (length, sha256 of the bytes, first 16 hex digits)
PINNED = {
    3000000001: {"q_due": (136, "97e3123bb55a55fc"),
                 "q_idx": (136, "16fcd5aac4a19118"),
                 "sample": (136, "1550e7223e42bce2")},
    2147495993: {"q_due": (144, "d66d1ec5ab5eceec"),
                 "q_idx": (144, "63ab49495c3a483b"),
                 "sample": (144, "d47b7c2b056a9680")},
}


@pytest.mark.parametrize("seed", sorted(PINNED))
def test_uniform_draws_are_todays(root, seed):
    from bench.cell import Cell, Inputs

    c = Cell(root, "tiny.query")
    inp = Inputs(c.cfg, c.traffic, c.dep, seed, 0.5, "cpu")
    for name, (n, digest) in PINNED[seed].items():
        a = np.ascontiguousarray(getattr(inp, name))
        assert (a.shape[0], hashlib.sha256(a.tobytes()).hexdigest()[:16]) == (
            n, digest), name


def test_zipf_draws_follow_the_law():
    """Over 512 queries at s = 1.1 the ranks' shares are the law's. The
    tolerance is five binomial standard deviations at this many draws
    (~0.004 at rank 1): a sound draw misses it with odds under 1e-6,
    while a law off by a tenth in s moves rank 1's share by ~0.03."""
    from bench.cell import pool_draws

    pool, s, n, seed = 512, 1.1, 200_000, 7
    idx = pool_draws(np.random.default_rng(seed), {"zipf_s": s}, pool, n)
    rank_to_query = np.random.default_rng(seed).permutation(pool)
    rank = np.empty(pool, np.int64)
    rank[rank_to_query] = np.arange(pool)
    counts = np.bincount(rank[idx], minlength=pool)
    law = 1.0 / np.arange(1, pool + 1) ** s
    law /= law.sum()
    for head in (1, 4, 16, 64, 256):
        p = law[:head].sum()
        got = counts[:head].sum() / n
        assert abs(got - p) <= 5 * np.sqrt(p * (1 - p) / n), (head, got, p)
    # every query keeps a rank: the tail is drawn too
    assert (counts[-64:] > 0).all()


def test_the_law_changes_only_the_pool_indices(root):
    """tiny.cached's traffic is tiny.query's with ``zipf_s``: the same pool
    and due times, indices drawn by rank."""
    from bench.cell import Cell, Inputs

    seed = 3000000001
    a = Cell(root, "tiny.query")
    b = Cell(root, "tiny.cached")
    ia = Inputs(a.cfg, a.traffic, a.dep, seed, 0.5, "cpu")
    ib = Inputs(b.cfg, b.traffic, b.dep, seed, 0.5, "cpu")
    assert np.array_equal(ia.pool, ib.pool)
    assert np.array_equal(ia.q_due, ib.q_due)
    assert not np.array_equal(ia.q_idx, ib.q_idx)
    # the head of the ranks takes most draws: a few queries repeat
    top = np.sort(np.bincount(ib.q_idx, minlength=ib.pool.shape[0]))[::-1]
    assert top[:8].sum() > 0.4 * ib.q_idx.size
