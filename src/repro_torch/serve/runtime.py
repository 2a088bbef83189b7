"""Serving runtime: the micro-batching query front end shared by the
port's servers, and ``AsyncServer``, which ingests on a background
thread and answers from published snapshots (the paper's "index refresh
without interrupting queries").

``QueryFrontend`` queues queries with monotone tickets, flushes them in
batches of up to ``max_batch`` (or after ``max_wait_ms``), answers each
batch through the subclass's ``_query_batch`` under a per-flush
``QueryPlan`` and keeps bounded latency windows; ``drain()`` loops
``flush()`` so no pending query is dropped. With two-stage serving every
flush picks its plan from a ``PlanSpace`` ladder; ``ServerConfig.adaptive``
arms the hysteretic ``DegradationController``, which under queue pressure
shrinks rerank depth, then nprobe, then sheds, and every degraded answer
says so (``degraded``/``shed``/``plan``).

``AsyncServer`` (the reference's ``serve/runtime.py::AsyncServer``):

* ``ingest`` puts a stream batch on a bounded queue; a supervised ingest
  thread drains it into the engine and publishes a ``ServingSnapshot``
  every ``publish_every`` batches by one reference swap;
* ``flush`` answers each batch from the one snapshot it pinned, so a
  concurrent publish never tears an answer, and every answer carries the
  ``snapshot_version`` it was served from;
* failures are classified (``durability.classify_error``): transient ones
  restart the loop with seeded-jitter backoff, a batch that fails its
  admission ``quarantine_after`` times is quarantined, fatal ones surface
  on the caller's next ``submit``/``flush``/``sync``/``close``.

On a card the server owns one ``torch.cuda.Stream`` for ingest: the ingest
thread runs ``engine.ingest`` and ``engine.publish`` under it, and the
query path stays on its own thread's stream (the kernels' wrappers read
the current stream at every launch). A publish records an event on the
ingest stream after its clones; the event travels with the snapshot, the
query path makes its stream wait on it before serving, and marks the
snapshot's tensors as used on its stream (``record_stream``) so the
caching allocator never hands their blocks to ingest while a flush still
reads them. Neither path synchronizes the device: ingest's host reads
(the ring write's row pick, publish's change signature) wait on the
ingest stream only. On the CPU the same class runs without streams.

Not yet ported (ROADMAP A6): the result cache and hot set
(``ServerConfig.cache_entries``/``hotset`` raise ``NotImplementedError``),
durability (``AsyncServer(durability=...)`` raises), fault points and the
metrics/trace spans of ``obs``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import random
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import pipeline
from repro_torch.engine.engine import Engine, ServingSnapshot
from repro_torch.engine.plan import PlanSpace
from repro_torch.serve.durability import classify_error
from repro_torch.serve.executor import DegradationController, PriorityDispatcher

NOT_PORTED = ("arrives with the rest of the port's serving runtime (ROADMAP A6: "
              "result cache, hot set, durability, obs)")


@dataclasses.dataclass
class ServerConfig:
    max_batch: int = 64
    max_wait_ms: float = 2.0
    topk: int = 10
    two_stage: bool = False    # routed two-stage retrieval (document store)
    nprobe: int = 8            # clusters routed per query when two_stage
    latency_window: int = 1024  # per-batch latencies kept for p50/p99
    # ---- query-adaptive serving (two_stage only) ----
    # adaptive=True arms the degradation controller: under queue pressure
    # each flush walks the PlanSpace ladder (full -> shrink depth ->
    # shrink nprobe -> shed) and answers carry an explicit ``degraded``/
    # ``shed`` marker. adaptive=False always serves the full-effort plan.
    adaptive: bool = False
    max_queue_depth: int = 256  # pending queries (post-flush) that escalate
    low_queue_depth: int | None = None  # recovery watermark (None = high//4)
    recover_after: int = 4      # calm flushes required to step back up
    min_depth: int = 1          # floor of the depth ladder
    min_nprobe: int = 1         # floor of the nprobe ladder
    # ---- the hot-set serving cache: not yet ported (raise) ----
    cache_entries: int = 0
    hotset: bool = False


class QueryFrontend:
    """Micro-batching query front end shared by the sync and async servers.

    Subclasses implement ``_query_batch(q, plan) -> (scores, rows, ids,
    clusters)`` and may override ``_batch_meta()`` to tag answers. Tickets
    are monotone for the life of the server, and each answer carries its
    ``ticket``."""

    def __init__(self, cfg: "pipeline.PipelineConfig", server_cfg: ServerConfig,
                 embed_fn: Callable[[list], np.ndarray] | None = None):
        for name, on in (("cache_entries", server_cfg.cache_entries),
                         ("hotset", server_cfg.hotset)):
            if on:
                raise NotImplementedError(f"ServerConfig.{name} {NOT_PORTED}")
        if server_cfg.two_stage:  # fail at construction, not first flush
            assert cfg.store_depth > 0, \
                "two_stage serving needs a PipelineConfig with store_depth > 0"
            assert server_cfg.topk <= server_cfg.nprobe * cfg.store_depth, \
                "topk must be <= nprobe * store_depth"
            assert server_cfg.nprobe <= cfg.hh.bmax(), \
                "nprobe must be <= the prototype index capacity"
        self.cfg = cfg
        self.scfg = server_cfg
        self.embed_fn = embed_fn
        # the plan ladder (two_stage only); adaptive serving walks it
        self.plan_space: PlanSpace | None = None
        self._full_plan = None
        self._controller: DegradationController | None = None
        if server_cfg.two_stage:
            self.plan_space = PlanSpace(
                nprobe=server_cfg.nprobe, depth=cfg.store_depth,
                k=server_cfg.topk, min_depth=server_cfg.min_depth,
                min_nprobe=server_cfg.min_nprobe)
            self._full_plan = self.plan_space.full
            if server_cfg.adaptive:
                self._controller = DegradationController(
                    self.plan_space, high=server_cfg.max_queue_depth,
                    low=server_cfg.low_queue_depth,
                    recover_after=server_cfg.recover_after)
        else:
            assert not server_cfg.adaptive, \
                "adaptive serving requires two_stage=True"
        self._pending: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._next_ticket = 0
        self._lat_sum = 0.0
        self._last_snapshot = None
        self.stats = {
            "queries": 0, "docs": 0, "batches": 0, "shed": 0,
            "query_latency_ms":
                collections.deque(maxlen=server_cfg.latency_window),
            # per-query enqueue->answer latencies: what a caller waits
            "answer_latency_ms":
                collections.deque(maxlen=server_cfg.latency_window),
        }

    def submit(self, query) -> int:
        """Queue one query (text if embed_fn is set, else an embedding).
        Returns a monotonically increasing ticket id."""
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._pending.append(
                {"q": query, "t": time.perf_counter(), "ticket": ticket})
        return ticket

    def _flush_due(self) -> bool:
        with self._lock:
            if not self._pending:
                return False
            if len(self._pending) >= self.scfg.max_batch:
                return True
            age_ms = (time.perf_counter() - self._pending[0]["t"]) * 1e3
        return age_ms >= self.scfg.max_wait_ms

    def _choose_plan(self, queue_depth: int):
        """The degradation controller's plan (adaptive), else the fixed
        full-effort plan; None for prototype-only serving."""
        if self._controller is not None:
            return self._controller.observe(queue_depth)
        return self._full_plan

    def flush(self) -> list[dict]:
        """Answer up to ``max_batch`` queued queries as one batch, under
        the plan chosen from the post-batch queue depth. A shed plan
        answers the whole batch at once with sentinel results (scores
        -inf, ids and clusters -1) and never touches the engine; answers
        carry ``degraded`` (effort below full, shed included), ``shed``
        and ``plan``."""
        with self._lock:
            if not self._pending:
                return []
            batch = [self._pending.popleft()
                     for _ in range(min(len(self._pending),
                                        self.scfg.max_batch))]
            depth = len(self._pending)
        plan = self._choose_plan(depth)
        degraded = plan is not None and (plan.shed or plan != self._full_plan)
        t0 = time.perf_counter()
        if plan is not None and plan.shed:
            k = self.scfg.topk
            scores = np.full((len(batch), k), -np.inf, np.float32)
            ids = np.full((len(batch), k), -1, np.int32)
            labels = np.full((len(batch), k), -1, np.int32)
        else:
            raw = [b["q"] for b in batch]
            q = self.embed_fn(raw) if self.embed_fn is not None else np.stack(raw)
            scores, _, ids, labels = self._query_batch(
                np.asarray(q, np.float32), plan)
            # one host transfer per output
            scores, ids, labels = (scores.cpu().numpy(), ids.cpu().numpy(),
                                   labels.cpu().numpy())
        lat = (time.perf_counter() - t0) * 1e3
        meta = self._batch_meta()
        if plan is not None:
            meta = {**meta, "degraded": degraded, "shed": plan.shed,
                    "plan": {"nprobe": plan.nprobe, "depth": plan.depth}}
        out = [{
            "ticket": b["ticket"],
            "scores": scores[i],
            "doc_ids": ids[i],
            "clusters": labels[i],
            "enqueue_to_answer_ms": (time.perf_counter() - b["t"]) * 1e3,
            **meta,
        } for i, b in enumerate(batch)]
        with self._lock:
            self.stats["queries"] += len(batch)
            self.stats["batches"] += 1
            if plan is not None and plan.shed:
                self.stats["shed"] += len(batch)
            self.stats["query_latency_ms"].append(lat)
            for o in out:
                self.stats["answer_latency_ms"].append(
                    o["enqueue_to_answer_ms"])
            self._lat_sum += lat
        return out

    def drain(self) -> list[dict]:
        """Flush until no query is left pending — the shutdown path."""
        out: list[dict] = []
        while True:
            got = self.flush()
            if not got:
                return out
            out.extend(got)

    def latency_stats(self) -> dict:
        """Running mean over all batches; percentiles over the bounded
        windows — per-batch dispatch latency (``p*_ms``) and per-query
        enqueue->answer latency (``answer_p*_ms``). The schema is the
        reference's and constant; the serving-cache keys are 0 (no cache
        is ported yet)."""
        with self._lock:
            window = np.asarray(self.stats["query_latency_ms"], np.float64)
            answers = np.asarray(self.stats["answer_latency_ms"], np.float64)
            n = self.stats["batches"]
            lat_sum = self._lat_sum

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else 0.0

        return {
            "batches": n,
            "mean_ms": lat_sum / n if n else 0.0,
            "p50_ms": pct(window, 50), "p90_ms": pct(window, 90),
            "p99_ms": pct(window, 99), "window": int(window.size),
            "answer_p50_ms": pct(answers, 50),
            "answer_p90_ms": pct(answers, 90),
            "answer_p99_ms": pct(answers, 99),
            "answer_window": int(answers.size),
            "cache_hit_rate": 0.0,
            "pinned_bytes": 0,
        }

    def _query_batch(self, q: np.ndarray, plan=None):
        raise NotImplementedError

    def _batch_meta(self) -> dict:
        return {}


class _Published(NamedTuple):
    """A published snapshot and, on a card, the ingest-stream event after
    its clones (None on the CPU); swapped in as one reference."""

    snap: ServingSnapshot
    ready: "torch.cuda.Event | None"


class AsyncServer(QueryFrontend):
    """Background-ingest serving runtime over an ``Engine``.

    ``ingest`` enqueues a stream batch and returns (a full queue blocks
    the producer, never the query path); the ingest thread applies it and
    publishes every ``publish_every`` batches; ``sync``/``close`` publish
    the tail. ``flush`` answers from the snapshot it pins once per batch.
    Runs on ``cuda`` unless ``device`` (or the given engine) says
    otherwise.

    The priority dispatcher: a flush holds its query section while it
    queues its serve work; the ingest thread enters the ingest section
    before each batch and each publish and leaves it at once. On one card
    the two paths queue onto separate streams, so nothing needs them
    mutually excluded (the reference serializes multi-device enqueue
    order, which one card does not have); holding the section across a
    batch would make a flush wait out that batch's host sync. So a queued
    flush goes ahead of the next ingest step, and no flush waits for an
    ingest batch to finish.
    """

    _STOP = object()

    def __init__(self, cfg: "pipeline.PipelineConfig", server_cfg: ServerConfig,
                 seed: int | None = None, warmup=None, embed_fn=None,
                 engine: Engine | None = None, publish_every: int = 4,
                 queue_max: int = 64, durability=None, max_restarts: int = 8,
                 backoff_base_s: float = 0.01, backoff_max_s: float = 1.0,
                 supervise_seed: int = 0, device=None):
        if durability is not None:
            raise NotImplementedError(f"AsyncServer(durability=...) {NOT_PORTED}")
        super().__init__(cfg, server_cfg, embed_fn)
        if engine is not None:
            assert engine.cfg == cfg, "engine.cfg disagrees with cfg"
        else:
            assert seed is not None, "either an engine or an init seed"
            engine = Engine(cfg, seed, warmup, device=device)
        self.engine = engine
        self.publish_every = max(1, publish_every)
        self._stream = None
        if engine.device.type == "cuda":
            # the ingest stream takes over the live state: it waits for the
            # work that made it, and the allocator learns that it uses the
            # state's blocks (ingest frees the initial tensors as it
            # replaces them)
            self._stream = torch.cuda.Stream(engine.device)
            self._stream.wait_stream(torch.cuda.current_stream(engine.device))
            for t in _tensors(engine.state):
                t.record_stream(self._stream)
        # ---- supervision ----
        self.max_restarts = max_restarts
        self._backoff = (backoff_base_s, backoff_max_s)
        self._jitter = random.Random(supervise_seed)
        self.restarts = 0
        self.quarantined: list[int] = []   # poison-batch seqs (never silent)
        self._attempts: dict[int, int] = {}
        self._quarantine_after = 3
        self._error_seq: int | None = None
        self._inflight = None              # ingest-thread resume state
        self._inflight_stage = "done"
        self._next_seq = 0
        self._ingest_lock = threading.Lock()  # seq order == queue order
        self._docs_ingested = 0             # ingest-thread private
        self._published = self._publish_now()   # queries never see None
        self._published_docs = 0
        self._since_publish = 0
        self._error: BaseException | None = None
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, queue_max))
        self._dispatch = PriorityDispatcher()
        self._closed = False
        self._stop_sent = False
        self._thread = threading.Thread(
            target=self._ingest_loop, name="rag-ingest", daemon=True)
        self._thread.start()

    @property
    def _snapshot(self) -> ServingSnapshot:
        return self._published.snap

    def _on_ingest_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _publish_now(self) -> _Published:
        """``engine.publish`` on the ingest stream, with its ready event."""
        with self._on_ingest_stream():
            snap = self.engine.publish()
            ready = None
            if self._stream is not None:
                ready = torch.cuda.Event()
                ready.record(self._stream)
        return _Published(snap, ready)

    # ---------------------------------------------------------- ingest thread
    def _ingest_loop(self):
        """Supervisor: runs the ingest loop, classifies failures, and
        restarts it with exponential backoff + seeded jitter within a
        bounded budget. Fatal errors (and an exhausted budget) surface on
        the caller thread with the failing batch's sequence number."""
        while True:
            try:
                self._ingest_run()
                return
            except BaseException as e:  # surfaced by _check, never dropped
                seq = (self._inflight[0]
                       if isinstance(self._inflight, tuple) else None)
                if (classify_error(e) == "fatal"
                        or self.restarts >= self.max_restarts):
                    self._error_seq = seq
                    self._error = e  # set LAST: _check reads seq after it
                    return
                self.restarts += 1
                base, cap = self._backoff
                delay = min(cap, base * (2 ** (self.restarts - 1)))
                time.sleep(delay * (1.0 + 0.25 * self._jitter.random()))
                self._on_restart(seq)

    def _ingest_run(self):
        """One supervised incarnation of the ingest loop. Per-batch work
        is a resumable stage machine (admit -> publish): after a
        mid-batch failure the restart resumes at the failing stage, so an
        applied batch is never ingested twice and a failed cadence
        publish is retried at once."""
        while True:
            item = self._inflight
            if item is None:
                item = self._queue.get()
                self._inflight = item
                self._inflight_stage = "admit"
            if item is self._STOP:
                self._publish()
                self._inflight = None
                return
            if isinstance(item, threading.Event):  # sync barrier
                self._publish()
                item.set()
                self._inflight = None
                continue
            seq, x, ids, draws = item
            if self._inflight_stage == "admit":
                with self._dispatch.ingest():   # queued flushes go first
                    pass
                with self._on_ingest_stream():
                    self.engine.ingest(x, ids, draws)
                self._docs_ingested += int(np.sum(np.asarray(ids) >= 0))
                self._since_publish += 1
                self._attempts.pop(seq, None)
                self._inflight_stage = "publish"
            if self._inflight_stage == "publish":
                if self._since_publish >= self.publish_every:
                    self._publish()
                self._inflight = None
                self._inflight_stage = "done"

    def _on_restart(self, seq: int | None):
        """Post-backoff restart hygiene: a batch that burned its retry
        budget at the admit stage is quarantined — dropped from the retry
        loop only, counted and remembered."""
        if seq is not None and self._inflight_stage == "admit":
            n = self._attempts.get(seq, 0) + 1
            self._attempts[seq] = n
            if n >= self._quarantine_after:
                self.quarantined.append(seq)
                self._attempts.pop(seq, None)
                self._inflight = None
                self._inflight_stage = "done"

    def _publish(self):
        # the doc watermark BEFORE publishing: the snapshot holds at
        # least everything ingested up to here
        docs = self._docs_ingested
        with self._dispatch.ingest():   # queued flushes go first
            pass
        self._published = self._publish_now()   # one reference swap
        self._published_docs = docs
        self._since_publish = 0

    def _check(self):
        if self._error is not None:
            seq = self._error_seq
            raise RuntimeError(
                "async ingest thread died"
                + (f" (batch seq {seq})" if seq is not None else "")
            ) from self._error

    def _put(self, item, timeout: float):
        """Queue.put that can never deadlock on a dead ingest thread."""
        deadline = time.monotonic() + timeout
        while True:
            self._check()
            if not self._thread.is_alive():
                raise RuntimeError("ingest thread is not running")
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                if time.monotonic() >= deadline:
                    raise TimeoutError("ingest queue stayed full") from None

    # -------------------------------------------------------------- protocol
    def ingest(self, embeddings, doc_ids, draws: dict | None = None,
               timeout: float = 120.0):
        """Enqueue one stream batch for background ingestion (bounded
        queue: blocks the producer, never the query path, when full).
        ``draws`` are the heavy-hitter's per-arrival draws for this batch
        (``heavy_hitter.update_batch``); None draws them from the engine's
        generator."""
        if self._closed:
            raise RuntimeError(
                "server is closed: ingest() after close() would never "
                "be applied")
        self._check()
        x = np.asarray(embeddings)
        ids = np.asarray(doc_ids)
        with self._ingest_lock:
            seq = self._next_seq
            self._next_seq += 1
            self._put((seq, x, ids, draws), timeout)
        # live rows only (doc_id < 0 is padding), as _docs_ingested counts
        with self._lock:
            self.stats["docs"] += int(np.sum(ids >= 0))

    def submit(self, query) -> int:
        """Queue one query; raises after ``close()`` and with the ingest
        thread's stored error instead of queueing a doomed ticket."""
        if self._closed:
            raise RuntimeError(
                "server is closed: submit() after close() would never "
                "be answered")
        self._check()
        return super().submit(query)

    def flush(self) -> list[dict]:
        self._check()
        return super().flush()

    def _query_batch(self, q: np.ndarray, plan=None):
        self._check()
        pub = self._published         # pin ONE snapshot for the whole batch
        snap = pub.snap
        self._last_snapshot = snap
        with self._dispatch.query():
            if pub.ready is not None:
                stream = torch.cuda.current_stream(self.engine.device)
                stream.wait_event(pub.ready)
                for t in _tensors(snap):
                    t.record_stream(stream)
            return self.engine.query_snapshot(
                snap, q, self.scfg.topk, two_stage=self.scfg.two_stage,
                nprobe=self.scfg.nprobe, plan=plan)

    def _batch_meta(self) -> dict:
        # a shed flush never pins a snapshot: it reports the current one
        snap = (self._last_snapshot if self._last_snapshot is not None
                else self._snapshot)
        return {"snapshot_version": snap.version}

    def serve_round(self, stream_batch=None) -> list[dict]:
        """Answer due queries FIRST (from the published snapshot), then
        enqueue the stream batch — the opposite order of
        ``RAGServer.serve_round``, and why queries here never pay for
        ingest."""
        outs = self.flush() if self._flush_due() else []
        if stream_batch is not None:
            self.ingest(stream_batch["embedding"], stream_batch["doc_id"])
        return outs

    # ------------------------------------------------------------- lifecycle
    def sync(self, timeout: float = 120.0):
        """Block until everything enqueued so far is ingested AND
        published."""
        deadline = time.monotonic() + timeout
        ev = threading.Event()
        self._put(ev, timeout)
        while not ev.wait(0.05):   # a dead ingest thread surfaces at once
            self._check()
            if time.monotonic() >= deadline:
                raise TimeoutError("ingest thread did not sync in time")

    def close(self, timeout: float = 120.0):
        """Stop the ingest thread after a final publish; idempotent once
        the thread has stopped (a timed-out close can be retried)."""
        if self._closed:
            return
        if not self._stop_sent and self._thread.is_alive():
            self._put(self._STOP, timeout)
            self._stop_sent = True
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("ingest thread did not stop in time")
        self._closed = True
        self._check()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ accounting
    def state_memory_bytes(self) -> int:
        """Engine state bytes (the hot tier, which would add its pinned
        bytes, is not ported)."""
        return self.engine.state_memory_bytes()

    def robustness_stats(self) -> dict:
        """Supervision accounting, in the reference's constant schema
        (the durability keys are zero / None / empty: none is ported)."""
        return {
            "restarts": self.restarts,
            "max_restarts": self.max_restarts,
            "quarantined": list(self.quarantined),
            "error_seq": self._error_seq,
            "durable": False,
            "recovery": None,
            "journal_last_seq": -1,
            "journal_segments": 0,
            "journal_disk_bytes": 0,
            "journal_lag_batches": 0,
            "checkpoint_seq": None,
            "checkpoint_age_batches": 0,
            "checkpoint_saves": {"full": 0, "delta": 0, "failed": 0},
            "checkpoint_bytes": {"full": 0, "delta": 0},
        }

    def freshness_stats(self) -> dict:
        """How far the published snapshot trails the ingested stream, in
        docs (lag) and seconds (age; None for a snapshot never actually
        published)."""
        snap = self._snapshot
        published_at = snap.published_at if snap.published_at > 0 else None
        return {
            "snapshot_version": snap.version,
            "published_at": published_at,
            "snapshot_age_s": (time.time() - published_at
                               if published_at is not None else None),
            "docs_enqueued": self.stats["docs"],
            "docs_ingested": self._docs_ingested,
            "docs_published": self._published_docs,
            "lag_docs": self.stats["docs"] - self._published_docs,
        }


def _tensors(tree):
    """Every tensor of a (nested) tuple state or snapshot."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, tuple):
        for leaf in tree:
            yield from _tensors(leaf)
