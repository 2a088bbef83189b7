"""The port's serving executor (``PriorityDispatcher``,
``DegradationController``) against the JAX package's, fed the same
queue-depth sequences and the same acquisition scenarios: every plan,
level and acquisition order must be equal."""
import sys
import threading
import time

import numpy as np
import pytest

from repro.engine.plan import PlanSpace as JPlanSpace
from repro.serve import executor as jex
from repro_torch.engine.plan import PlanSpace as TPlanSpace
from repro_torch.serve import executor as tex

pytestmark = pytest.mark.timeout(120)

LADDERS = [  # (nprobe, depth, k, min_depth, min_nprobe)
    (8, 64, 10, 1, 1), (4, 4, 5, 1, 1), (16, 32, 10, 4, 2), (8, 16, 100, 1, 1)]


def _plan(p):
    return (p.nprobe, p.depth, p.shed)


@pytest.mark.parametrize("ladder", LADDERS)
@pytest.mark.parametrize("high,low,recover_after", [(6, 0, 2), (32, None, 4),
                                                    (100, 99, 1)])
def test_degradation_controller_matches_reference(ladder, high, low, recover_after):
    nprobe, depth, k, min_depth, min_nprobe = ladder
    kw = dict(nprobe=nprobe, depth=depth, k=k, min_depth=min_depth,
              min_nprobe=min_nprobe)
    js, ts = JPlanSpace(**kw), TPlanSpace(**kw)
    assert [_plan(p) for p in ts.ladder] == [_plan(p) for p in js.ladder]
    jc = jex.DegradationController(js, high=high, low=low,
                                   recover_after=recover_after)
    tc = tex.DegradationController(ts, high=high, low=low,
                                   recover_after=recover_after)
    assert (tc.high, tc.low, tc.recover_after) == (jc.high, jc.low, jc.recover_after)
    rng = np.random.default_rng(high + recover_after)
    # bursts above the high watermark, calm stretches at/below the low one,
    # and readings in between
    depths = np.concatenate([rng.integers(0, 3 * high, 200),
                             np.zeros(40, np.int64), np.full(10, high + 1),
                             rng.integers(0, high + 1, 100)])
    for d in depths:
        jp, tp = jc.observe(int(d)), tc.observe(int(d))
        assert _plan(tp) == _plan(jp) and tc.level == jc.level


def _acquisition_order(ex_mod):
    """An ingest holder keeps the section while two ingest and then two
    query waiters queue; returns the order they acquire in."""
    d = ex_mod.PriorityDispatcher()
    order, held, release = [], threading.Event(), threading.Event()

    def holder():
        with d.ingest():
            held.set()
            release.wait(10)

    def waiter(kind, name):
        with getattr(d, kind)():
            order.append(name)

    h = threading.Thread(target=holder)
    h.start()
    assert held.wait(10)
    waiters = []
    for kind, name in (("ingest", "i1"), ("ingest", "i2"), ("query", "q1"),
                       ("query", "q2")):
        t = threading.Thread(target=waiter, args=(kind, name))
        t.start()
        waiters.append(t)
        time.sleep(0.05)   # each waiter queued before the next
    deadline = time.monotonic() + 10
    while d._queries_waiting < 2:   # both queries queued before the release
        assert time.monotonic() < deadline
        time.sleep(0.001)
    release.set()
    for t in [h, *waiters]:
        t.join(10)
    assert not any(t.is_alive() for t in [h, *waiters])
    return order


def test_priority_dispatcher_orders_like_reference():
    want = _acquisition_order(jex)
    got = _acquisition_order(tex)
    # queries first, then ingest (notify_all promises no order within a class)
    for order in (want, got):
        assert set(order[:2]) == {"q1", "q2"} and set(order[2:]) == {"i1", "i2"}


@pytest.mark.parametrize("ex_mod", [jex, tex], ids=["jax", "torch"])
def test_priority_dispatcher_is_exclusive_under_stress(ex_mod):
    """More threads than cores and a tiny switch interval: never two
    holders at once, and every acquisition completes."""
    d = ex_mod.PriorityDispatcher()
    holders, worst, done = [0], [0], []
    lock = threading.Lock()

    def worker(kind, n):
        for _ in range(n):
            with getattr(d, kind)():
                with lock:
                    holders[0] += 1
                    worst[0] = max(worst[0], holders[0])
                holders_now = holders[0]
                with lock:
                    holders[0] -= 1
                assert holders_now >= 1
        done.append(kind)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k, 200))
                   for k in ("query", "ingest") * 8]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(done) == 16 and worst[0] == 1
