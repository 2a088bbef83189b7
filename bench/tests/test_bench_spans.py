"""The readers of the program's stage spans: ``flush_idle_ms.p50``,
``flush_launch_ms.p50``, ``flush_answers_ms.p50`` and
``frontend_wait_ms.p95``, on synthetic records (the overlap arithmetic,
the window's clipping, a record without a device trace or without the
spans) and in a traced run at test size on the CPU."""
from __future__ import annotations

import math

import pytest

from bench import cell
from bench.tests import _tiny

NEW = ("flush_idle_ms.p50", "flush_launch_ms.p50", "flush_answers_ms.p50",
       "frontend_wait_ms.p95")


def reader(name):
    return cell.load_metric(_tiny.REPO / "bench", name)


def rec(spans, busy=None, window=(0.0, 10.0)):
    r = {"window": window,
         "program_spans": [(n, a, b, args, 7) for n, a, b, args in spans]}
    if busy is not None:
        r["busy"] = busy
    return r


def test_flush_idle_subtracts_each_busy_interval_it_overlaps():
    busy = [(1.0, 2.0), (2.5, 3.0), (4.0, 6.0), (8.0, 8.1)]
    spans = [("flush", 0.5, 2.75, {}),     # straddles two intervals: 2.25 - 1.25
             ("flush", 3.0, 4.0, {}),      # between them, touching both: 1.0
             ("flush", 4.5, 5.5, {}),      # inside one: 0
             ("flush.launch", 6.0, 9.0, {})]   # another name: not read
    got = reader("flush_idle_ms.p50")(rec(spans, busy))
    assert got == pytest.approx(1.0e3)     # the median of 1.0, 1.0 and 0
    spans.append(("flush", 7.9, 8.2, {}))  # 0.3 - 0.1
    assert reader("flush_idle_ms.p50")(rec(spans, busy)) == pytest.approx(
        0.6e3)                             # the median of 0, 0.2, 1.0, 1.0
    assert reader("flush_idle_ms.p50")(rec(spans, [])) == pytest.approx(
        1.0e3)                             # an idle device: each whole span


def test_flush_idle_needs_a_device_trace():
    assert reader("flush_idle_ms.p50")(rec([("flush", 1.0, 2.0, {})])) is None


def test_readers_read_only_spans_wholly_inside_the_window():
    spans = []
    for name in ("flush", "flush.launch", "flush.answers"):
        spans += [(name, 0.5, 1.5, {}), (name, 9.5, 10.5, {}),
                  (name, 2.0, 2.004, {})]
    spans += [("query", 0.5, 1.5, {"wait_us": 9e6}),
              ("query", 9.5, 10.5, {"wait_us": 9e6}),
              ("query", 2.0, 2.1, {"wait_us": 3000.0})]
    r = rec(spans, busy=[], window=(1.0, 10.0))
    for name in NEW:
        assert reader(name)(r) == pytest.approx(
            3.0 if name == "frontend_wait_ms.p95" else 4.0), name
    r["window"] = (3.0, 9.0)
    for name in NEW:
        assert reader(name)(r) is None, name


def test_frontend_wait_is_the_nearest_rank_p95_of_wait_us():
    waits = [float(i) * 1e3 for i in range(1, 101)]   # 1 ... 100 ms
    spans = [("query", 1.0, 2.0, {"wait_us": w}) for w in waits]
    spans.append(("query", 1.0, 2.0, {}))    # a query span without the arg
    assert reader("frontend_wait_ms.p95")(rec(spans)) == 95.0
    # a program whose query spans carry no wait: nothing to read
    assert reader("frontend_wait_ms.p95")(rec(spans[-1:])) is None


def test_a_traced_run_reads_the_span_metrics(tmp_path):
    root = _tiny.make(tmp_path)
    res = _tiny.run(root, "query", trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("flush_launch_ms.p50", "flush_answers_ms.p50",
                 "frontend_wait_ms.p95"):
        assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0, name
        assert m[name]["unit"] == "ms"
    assert "flush_idle_ms.p50" not in m      # no device trace on the CPU
    assert res["_rec"]["trace_dropped"] == 0
    names = {s[0] for s in res["_rec"]["program_spans"]}
    assert {"flush.stack", "flush.fetch", "engine.serve", "engine.decode",
            "engine.store", "engine.clone"} <= names
