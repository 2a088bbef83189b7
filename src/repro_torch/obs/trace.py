"""Structured span tracing exported as Chrome trace-event JSON.

Spans are recorded host-side (monotonic clock, microsecond resolution)
into a bounded in-memory buffer and exported in the Chrome trace-event
format — loadable in Perfetto / ``chrome://tracing`` — so a serving run
can be inspected as a timeline:

  * **query path**: one ``query`` span per request from submit to answer
    (args: ``ticket``, ``snapshot_version``, ``wait_us``), emitted after
    the ``flush`` span that answered it (args: batch fill, queue depth,
    the pinned snapshot version);
  * **inside a flush**, four children that tile it on the caller's
    thread: ``flush.stack`` (the batch made one array; ``embed`` nests in
    it), ``flush.launch`` (everything that queues the flush's device
    work: the snapshot pinned, the queries to the card, the serve call
    and the decode, as ``engine.serve`` and ``engine.decode``; on the
    cached path also that path's own device->host reads),
    ``flush.fetch`` (the answers' device->host copies: the host waits
    for the device here) and ``flush.answers`` (the answer dicts, the
    stats and the registry); a shed flush has ``flush.answers`` alone.
    Each ``query`` span's ``wait_us`` is its submit -> the start of the
    flush that answered it, the front end's own queue wait;
  * **ingest path**: ``ingest.enqueue`` (producer), ``ingest.admit`` (the
    background thread's engine dispatch), ``ingest.publish`` (snapshot
    reconcile + swap; args: version, dirty-cluster counts). Inside
    ``ingest.admit`` the engine's stages: ``engine.h2d`` (rows and ids
    to the card), ``engine.admit`` (the window, the admit kernel and the
    centroid fold), ``engine.count``, ``engine.reps``, ``engine.store``
    (the ring write and its one host sync) and, on refresh batches,
    ``engine.upsert``; inside ``ingest.publish``, ``engine.signature``
    (the change signature's host reads) and ``engine.clone``;
  * **set-up**: ``engine.init`` around the state's construction, with
    ``engine.kmeans_pp`` (the k-means++ start over a warmup buffer)
    inside it.

Correlation is by args: every query span carries the snapshot version it
was answered from, so freshness questions ("which queries saw stale
data?") are a Perfetto query over ``args.snapshot_version`` against the
``ingest.publish`` spans' versions.

Tracing shares the observability on/off contract of ``obs.metrics``:
sites fetch the active tracer once per batch via ``obs.tracer()`` and do
nothing when it is ``None``: a stage site is
``with tr.span(...) if tr is not None else NULL_SPAN:``, one test and no
new object.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time


# the stand-in span of a site with tracing off: one shared, reusable
# context that records nothing
NULL_SPAN = contextlib.nullcontext()


class _Span:
    """Mutable in-flight span; finished on ``__exit__`` or ``end()``."""

    __slots__ = ("tracer", "name", "cat", "args", "t0", "_done")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args      # mutable: fill correlation fields mid-span
        self.t0 = tracer.now_us()
        self._done = False

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        self.tracer._emit_complete(self.name, self.cat, self.t0,
                                   self.tracer.now_us() - self.t0, self.args)


class Tracer:
    """Bounded trace-event buffer with Chrome JSON export.

    ``max_events`` bounds memory on long runs (oldest events drop first —
    the tail of a serving run is usually what is being debugged). All
    emission paths are lock-protected; timestamps come from one process
    monotonic clock so spans from the query and ingest threads interleave
    correctly on the exported timeline.
    """

    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=max_events)
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._dropped = 0

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # ------------------------------------------------------------- record
    def span(self, name: str, cat: str = "serve", **args) -> _Span:
        """Context manager recording a complete ("X") event. The returned
        span's ``args`` dict is mutable — correlation fields discovered
        mid-span (e.g. the snapshot version pinned at flush) can be
        added before exit."""
        return _Span(self, name, cat, args)

    def complete(self, name: str, start_us: float, dur_us: float,
                 cat: str = "serve", **args) -> None:
        """Record a complete event from explicit host timestamps (used
        for per-query submit→answer spans, whose start predates the
        flush that answers them)."""
        self._emit_complete(name, cat, start_us, dur_us, args)

    def instant(self, name: str, cat: str = "serve", **args) -> None:
        self._append({"name": name, "cat": cat, "ph": "i",
                      "ts": self.now_us(), "s": "t",
                      "pid": self._pid, "tid": threading.get_ident(),
                      "args": args})

    def counter(self, name: str, values: dict, cat: str = "serve") -> None:
        """Chrome counter-track event ("C") — queue depth, lag, etc."""
        self._append({"name": name, "cat": cat, "ph": "C",
                      "ts": self.now_us(), "pid": self._pid,
                      "args": {k: float(v) for k, v in values.items()}})

    def _emit_complete(self, name, cat, ts, dur, args) -> None:
        self._append({"name": name, "cat": cat, "ph": "X",
                      "ts": ts, "dur": max(dur, 0.0),
                      "pid": self._pid, "tid": threading.get_ident(),
                      "args": args})

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    # ------------------------------------------------------------- export
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object format."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "args": {"name": "repro-streaming-rag"}}]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": dropped},
        }

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def validate_chrome_trace(obj: dict) -> list[str]:
    """Structural validation of a Chrome trace-event JSON object; returns
    a list of problems (empty = valid). Used by the CI smoke check and
    ``tests/test_torch_obs.py`` so "exported trace is valid" is a checked
    property, not an eyeball."""
    problems = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing traceEvents key"]
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["traceEvents is not a non-empty list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        for key in ("name", "ph", "pid"):
            if key not in ev:
                problems.append(f"event {i} ({ev.get('name')}) missing {key}")
        ph = ev.get("ph")
        if ph in ("X", "B", "E", "i", "C") and "ts" not in ev:
            problems.append(f"event {i} ({ev.get('name')}) missing ts")
        if ph == "X" and "dur" not in ev:
            problems.append(f"X event {i} ({ev.get('name')}) missing dur")
    return problems
