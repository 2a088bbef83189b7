"""The check must fail what it exists to catch: the precision control (the
reference computed with TF32 operands, put in the program's place) and
the faults a serving cell can have — ingest that leaves the state
unchanged, half of each batch left out, an answer altered where it is
produced, documents stored in the wrong cluster's ring, a result cache
that keeps every entry across a publish. Each run goes through the whole harness (inputs, the program,
the window, the check) at test size on the CPU; only the look for a card
is skipped. A single-chip cell has no exchange between chips to leave
out."""
from __future__ import annotations

import pytest
import torch

from bench.tests import _tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make(tmp_path_factory.mktemp("bench"))


def _unchanged(server):
    server.engine.ingest = lambda x, ids, draws=None: {"host_syncs": 0}


def _half_batch(server):
    inner = server.engine.ingest

    def ingest(x, ids, draws=None):
        h = max(1, len(ids) // 2)
        return inner(x[:h], ids[:h],
                     None if draws is None else {k: v[:h] for k, v in draws.items()})
    server.engine.ingest = ingest


def _answer_altered(server):
    inner = server.engine.query_snapshot

    def query(*a, **kw):
        scores, rows, ids, clusters = inner(*a, **kw)
        ids = ids.clone()
        ids[:, 0] = torch.where(ids[:, 0] >= 0, ids[:, 0] + 1, ids[:, 0])
        return scores, rows, ids, clusters
    server.engine.query_snapshot = query


def _stale_cache(server):
    """Every publish re-keys each cached answer to the new version and
    evicts none, though its routed rings changed."""
    cache = server._result_cache

    def on_publish(version, dirty):
        for e in cache._entries.values():
            e.version = version
    cache.on_publish = on_publish


@pytest.mark.parametrize("kind,fault", [
    ("query", _unchanged), ("ingest", _unchanged),
    ("query", _half_batch), ("ingest", _half_batch),
    ("query", _answer_altered), ("cached", _stale_cache)])
def test_a_broken_timed_path_is_not_correct(root, kind, fault):
    res = _tiny.run(root, kind, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ["query", "ingest"])
def test_a_mislabelled_store_is_not_correct(root, kind, monkeypatch):
    """Every kept document written into the ring of the cluster after its
    own: the check follows the shown cluster, and ``forced_miss`` counts
    each such choice, far off the reference's nearest centroid."""
    from repro_torch.engine import stages

    inner = stages.store_write

    def wrong_ring(cfg, store, x, labels, *a, **kw):
        k = store.ids.shape[0]
        return inner(cfg, store, x, (labels + 1) % k, *a, **kw)
    monkeypatch.setattr(stages, "store_write", wrong_ring)
    res = _tiny.run(root, kind)
    assert not res["correct"], res["checks"]
    assert res["checks"]["forced_miss"]["value"] > 0, res["checks"]


@pytest.mark.parametrize("kind", ["query", "ingest"])
def test_the_precision_control_is_not_correct(root, kind):
    from bench.cell import Cell, Inputs
    from bench.control import control_numbers

    c = Cell(root, f"tiny.{kind}")
    passed = {}
    for precision in ("fp32", "tf32"):
        inp = Inputs(c.cfg, c.traffic, c.dep, 3000000007, 1.0, "cpu")
        numbers, _ = control_numbers(c, inp, 3000000007, precision, 60)
        passed[precision] = all(numbers[k] <= lim for k, lim in c.limits.items())
    assert passed == {"fp32": True, "tf32": False}
