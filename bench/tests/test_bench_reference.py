"""The plain reference against the port's CPU path at test size, and the
frozen formulas against fixed values."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.tests import _tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("kind", ["query", "ingest"])
def test_reference_agrees_with_the_port_exactly(root, kind):
    res = _tiny.run(root, kind)
    rec = res["_rec"]
    assert res["correct"], res["checks"]
    assert res["checks"]["label_miss"]["value"] == 0
    assert res["checks"]["forced_miss"]["value"] == 0
    assert res["checks"]["state_diff"]["value"] == 0
    if kind == "query":
        assert res["checks"]["score_err"]["value"] < 1e-6
        assert res["checks"]["answer_gap"]["value"] < 1e-6
        assert res["attempted"] > 100 and res["failed"] == 0
        assert {"query_p50_ms", "setup_s"} <= set(res["metrics"])
    else:
        assert res["metrics"]["ingest_docs_per_s"]["value"] > 0
    # the check had something to compare: documents stored, prototypes live
    c = rec["counters"]
    assert c["store_live"] > 0 and c["index_valid"] > 0 and c["upserts"] > 0


def test_traced_run_reads_program_spans(root):
    res = _tiny.run(root, "ingest", seed=3000000003, trace=True)
    m = res["metrics"]
    assert res["correct"]
    assert m["ingest_batch_ms.p50"]["value"] > 0
    assert 0 < m["keep_share"]["value"] <= 100
    # no device trace on the CPU: the device metrics are left out, not 0
    assert "admit_roofline" not in m and "idle_share.ingest" not in m


def test_budget_rule():
    from bench.reference.pipeline import budget_rule

    assert budget_rule(4000.0, 384, 64, True) == (112501, 112501)
    assert budget_rule(1000.0, 384, 64, True) == (28125, 28125)
    assert budget_rule(150.0, 384, 64, True) == (4218, 4218)


def test_frozen_formulas():
    from bench.cost import PEAKS, admit, serve

    assert PEAKS["fp32_flops_per_s"] == 67e12
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12
    # the program's kernels/cost.py gave these for the same shapes
    assert serve.work(256, 384, 112501, 64, 16, 10) == (22319923200.0, 174187337)
    assert serve.bound(256, 384, 112501, 64, 16, 10) == pytest.approx(
        0.3331331820895523, rel=1e-12)
    assert admit.work(256, 384, 28125, 5) == (5552576256.0, 43703808)
    assert admit.bound(256, 384, 28125, 5) == pytest.approx(
        0.08287427247761195, rel=1e-12)


def test_tf32_rounding():
    from bench.reference.pipeline import tf32

    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -3.14159265], dtype=torch.float32)
    got = tf32(x).tolist()
    assert got[:4] == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9]   # ties to even
    assert got[4] == pytest.approx(-3.140625)


def test_counter_min_evict():
    from bench.reference.pipeline import Counter

    c = Counter(2, 0.5)
    f32 = np.float32
    assert c.arrive(7, f32(0.9)) and c.arrive(8, f32(0.9))   # room: no gate
    assert c.arrive(7, f32(0.9))                             # hit
    assert not c.arrive(9, f32(0.9))                         # full, gate shut
    assert c.arrive(9, f32(0.1))                             # evicts 8 (min)
    assert list(c.labels) == [7, 9] and list(c.counts) == [2, 1]
    assert (c.seen, c.evictions, c.writes) == (5, 1, 4)


def test_the_cached_cell_is_judged_at_each_answers_version(root):
    """tiny.cached: answers from the result cache and the hot tier are
    judged at the version their flush pinned, like any other, and the run
    reads correct; the cache and the tier served queries in the window,
    through the route pass, and their readers say how many."""
    from bench import cell

    res = _tiny.run(root, "cached")
    rec = res["_rec"]
    assert res["correct"], res["checks"]
    assert res["checks"]["score_err"]["value"] < 1e-6
    assert res["checks"]["answer_gap"]["value"] < 1e-6
    w = cell.window_serving(rec["serving"])
    assert w["cache"]["hits"] > 0 and w["cache"]["hot_served"] > 0, w
    assert w["cache"]["rekeyed"] > 0 and w["cache"]["invalidated"] > 0, w
    assert w["launches"]["serve_route"] > 0, w
    for name in ("cache_hit_share", "hot_tier_share"):
        got = cell.load_metric(_tiny.REPO / "bench", name)(rec)
        assert 0 < got < 100, (name, got)
        # an uncached deployment has nothing to read
        assert cell.load_metric(_tiny.REPO / "bench", name)(
            {**rec, "server": {"cache_entries": 0, "hotset": False}}) is None
