"""Dispatch scheduling + degradation policy for the async serving runtime
(the reference's ``serve/executor.py``, the same policy in plain Python).

``PriorityDispatcher`` is a two-queue priority section between the
ingest thread and the query path. A waiting query flush always acquires
before a waiting ingest dispatch: ingest only enters the section when no
query is waiting, so under load the query path never queues behind a
backlog of ingest work (ingest backpressure is the bounded stream
queue's job, not the dispatcher's). Within each class, arrival order is
preserved by the underlying condition queue. ``serve.runtime.
AsyncServer`` says how long each side holds it.

``DegradationController`` is the per-flush effort policy: it walks a
``PlanSpace`` degradation ladder (full -> shrink depth -> shrink nprobe
-> shed) on the queue-pressure signal the front end reads at every
flush (the queries still pending after the flush took its batch).
Escalation is immediate (one level per overloaded flush, so a sustained
burst reaches shedding quickly); recovery is hysteretic — the queue
must sit at/below the low watermark for ``recover_after`` consecutive
flushes before the controller steps back up one level, so the plan
doesn't thrash at the boundary.
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch.engine.plan import PlanSpace, QueryPlan


class PriorityDispatcher:
    """Two-class mutual-exclusion section: query acquisitions preempt
    ingest acquisitions (only in queueing order — a holder is never
    interrupted). Not reentrant; hold times must be dispatch-only."""

    def __init__(self):
        self._cond = threading.Condition()
        self._busy = False
        self._queries_waiting = 0

    @contextlib.contextmanager
    def query(self):
        """Acquire for a query-flush dispatch (high priority)."""
        with self._cond:
            self._queries_waiting += 1
            while self._busy:
                self._cond.wait()
            self._queries_waiting -= 1
            self._busy = True
        try:
            yield
        finally:
            with self._cond:
                self._busy = False
                self._cond.notify_all()

    @contextlib.contextmanager
    def ingest(self):
        """Acquire for an ingest/publish dispatch (low priority): waits
        while the section is held OR any query flush is queued for it."""
        with self._cond:
            while self._busy or self._queries_waiting:
                self._cond.wait()
            self._busy = True
        try:
            yield
        finally:
            with self._cond:
                self._busy = False
                self._cond.notify_all()


class DegradationController:
    """Hysteretic ladder walk over a :class:`PlanSpace`.

    ``observe(queue_depth)`` is called once per flush with the number of
    queries still pending after the flush batch was taken, and returns
    the plan for THIS flush. Above ``high`` the controller escalates one
    ladder level (ending in shed); at/below ``low`` for
    ``recover_after`` consecutive flushes it de-escalates one level.
    In-between readings reset the calm streak but hold the level.
    """

    def __init__(self, space: PlanSpace, *, high: int,
                 low: int | None = None, recover_after: int = 4):
        assert high > 0
        self.space = space
        self.high = high
        self.low = max(0, high // 4) if low is None else low
        assert self.low < self.high
        self.recover_after = max(1, recover_after)
        self.level = 0
        self._calm = 0

    def observe(self, queue_depth: int) -> QueryPlan:
        if queue_depth > self.high:
            if self.level < len(self.space.ladder) - 1:
                self.level += 1
            self._calm = 0
        elif queue_depth <= self.low:
            self._calm += 1
            if self._calm >= self.recover_after and self.level > 0:
                self.level -= 1
                self._calm = 0
        else:
            self._calm = 0
        return self.space.ladder[self.level]
