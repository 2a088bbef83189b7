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

The hot-set serving cache (``ServerConfig.cache_entries``/``hotset``,
two-stage ``AsyncServer`` only): a snapshot-versioned exact result cache
(``serve.result_cache``) and a query-side heavy-hitter hot set whose hot
clusters are pinned into a compact ring tier (``serve.hotset``). A cached
flush answers route-free exact hits first, then runs ONE route pass over
the pending queries (``stages.route_witnessed``: the ``mips`` kernel)
that verifies survivors of a publish, tests tier coverage and feeds the
query-side counter (the ``heavy_hitter`` kernel), then serves hot misses
over the tier and cold misses over the snapshot (both the ``serve``
kernel). The serve kernel answers a query the same whatever else shares
its launch, so sub-batches are served as they are: the reference's
power-of-two padding (``_pad_pow2``) only bounds its jit shapes. The two
kernels sum a route score in other orders, so at a near-tie they can
order a query's routes differently. Hence every served row's own routes
are held against the route pass's (where they differ a hot row is served
again from the snapshot and no row is cached), and a publish's survivor
is verified only where the pass's route scores are too far apart for any
summation order to reorder them (elsewhere it misses). A cached or tier
answer is thus always the snapshot's own.

Durability (``AsyncServer(durability=DurabilityConfig(...))``): every
batch is journaled (append + fsync) under the producer lock before it is
enqueued, the ingest thread checkpoints on ``checkpoint_every`` applied
batches (the host copies on the ingest stream, the write on a thread of
its own) and at ``close``, and the constructor recovers — restores the
checkpoint chain and replays the journal tail on the ingest stream —
before its first publish. Named fault points (``testing.faults``:
``ingest.enqueue``, ``ingest.admit``, ``publish``) and the ``obs`` spans
and metrics sit where the reference has them.
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

from repro_torch import obs
from repro_torch.core import pipeline
from repro_torch.engine import stages
from repro_torch.engine.engine import (Engine, ServingSnapshot, _resolve_plan,
                                       routed_query)
from repro_torch.engine.plan import PlanSpace
from repro_torch.serve.durability import (DurabilityConfig, DurableIngest,
                                          classify_error)
from repro_torch.serve.executor import DegradationController, PriorityDispatcher
from repro_torch.serve.hotset import HotSet
from repro_torch.serve.result_cache import ResultCache
from repro_torch.testing import faults


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
    # ---- hot-set serving cache (two_stage + AsyncServer only) ----
    # cache_entries > 0 arms the snapshot-versioned exact result cache
    # (``serve.result_cache``): repeat queries answer from recorded exact
    # results, delta publications invalidate only entries routed through
    # dirty clusters. hotset=True arms the query-side heavy-hitter hot
    # set (``serve.hotset``): the hot route sets' clusters pin into a
    # compact fast tier served through the serve kernel. Both are
    # bit-identical to uncached serving whenever they answer.
    cache_entries: int = 0      # result-cache capacity (0 = disabled)
    hotset: bool = False        # pinned hot-tier serving
    pin_budget_mb: float = 8.0  # hot-tier budget, charged against
    #                             state_memory_bytes (pow2-floored rows)
    hotset_capacity: int = 32   # HH tracker slots (route-set signatures)
    hotset_refresh: int = 16    # flushes between hot-set reselections
    hotset_min_count: int = 2   # min tracked count before a set pins


class QueryFrontend:
    """Micro-batching query front end shared by the sync and async servers.

    Subclasses implement ``_query_batch(q, plan) -> (scores, rows, ids,
    clusters)`` and may override ``_batch_meta()`` to tag answers. Tickets
    are monotone for the life of the server, and each answer carries its
    ``ticket``."""

    def __init__(self, cfg: "pipeline.PipelineConfig", server_cfg: ServerConfig,
                 embed_fn: Callable[[list], np.ndarray] | None = None):
        if server_cfg.two_stage:  # fail at construction, not first flush
            assert cfg.store_depth > 0, \
                "two_stage serving needs a PipelineConfig with store_depth > 0"
            assert server_cfg.topk <= server_cfg.nprobe * cfg.store_depth, \
                "topk must be <= nprobe * store_depth"
            assert server_cfg.nprobe <= cfg.hh.bmax(), \
                "nprobe must be <= the prototype index capacity"
        assert not (server_cfg.cache_entries or server_cfg.hotset) \
            or server_cfg.two_stage, \
            "the hot-set serving cache requires two_stage=True (cached " \
            "answers record routed clusters)"
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
        # telemetry is fetched ONCE per batch; both are None when disabled
        # and every obs branch below is skipped — the hot path stays free
        reg, tr = obs.metrics(), obs.tracer()
        plan_args = ({} if plan is None else
                     {"plan_nprobe": plan.nprobe, "plan_depth": plan.depth,
                      "degraded": degraded, "shed": plan.shed})
        fspan = (tr.span("flush", batch=len(batch), queue_depth=depth,
                         **plan_args)
                 if tr is not None else None)
        t0 = time.perf_counter()
        if plan is not None and plan.shed:
            k = self.scfg.topk
            scores = np.full((len(batch), k), -np.inf, np.float32)
            ids = np.full((len(batch), k), -1, np.int32)
            labels = np.full((len(batch), k), -1, np.int32)
        else:
            raw = [b["q"] for b in batch]
            if self.embed_fn is not None:
                if tr is not None:
                    with tr.span("embed", batch=len(batch)):
                        q = self.embed_fn(raw)
                else:
                    q = self.embed_fn(raw)
            else:
                q = np.stack(raw)
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
        if reg is not None:
            reg.counter("serve_queries_total").inc(len(batch))
            reg.counter("serve_batches_total").inc()
            reg.gauge("serve_queue_depth").set(depth)
            reg.gauge("serve_batch_fill").set(
                len(batch) / self.scfg.max_batch)
            reg.histogram("serve_batch_latency_ms", unit="ms").observe(lat)
            h = reg.histogram("serve_query_e2e_ms", unit="ms")
            for o in out:
                h.observe(o["enqueue_to_answer_ms"])
            if plan is not None:
                # serve.plan telemetry: what effort was actually chosen
                reg.histogram("serve_plan_nprobe", lo=0.5,
                              hi=2048.0).observe(float(plan.nprobe))
                reg.histogram("serve_plan_depth", lo=0.5,
                              hi=2048.0).observe(float(plan.depth))
                reg.gauge("serve_degradation_level").set(
                    self._controller.level
                    if self._controller is not None else 0)
                if plan.shed:
                    reg.counter("serve_shed_total").inc(len(batch))
        if tr is not None:
            fspan.args.update(meta if plan is None else
                              {k: v for k, v in meta.items() if k != "plan"})
            fspan.end()
            now = tr.now_us()
            # per-query submit->answer spans, correlated to the snapshot
            # they were answered from (and the plan that served them)
            for o in out:
                e2e_us = o["enqueue_to_answer_ms"] * 1e3
                tr.complete("query", now - e2e_us, e2e_us, cat="query",
                            ticket=o["ticket"],
                            **{k: v for k, v in o.items()
                               if k == "snapshot_version"},
                            **plan_args)
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
        reference's and constant for the life of the server, the
        serving-cache keys (``cache_hit_rate``/``pinned_bytes``) included:
        0 when caching is disabled or nothing has been served yet."""
        with self._lock:
            window = np.asarray(self.stats["query_latency_ms"], np.float64)
            answers = np.asarray(self.stats["answer_latency_ms"], np.float64)
            n = self.stats["batches"]
            lat_sum = self._lat_sum

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else 0.0

        cache = getattr(self, "_result_cache", None)
        hotset = getattr(self, "_hotset", None)
        return {
            "batches": n,
            "mean_ms": lat_sum / n if n else 0.0,
            "p50_ms": pct(window, 50), "p90_ms": pct(window, 90),
            "p99_ms": pct(window, 99), "window": int(window.size),
            "answer_p50_ms": pct(answers, 50),
            "answer_p90_ms": pct(answers, 90),
            "answer_p99_ms": pct(answers, 99),
            "answer_window": int(answers.size),
            "cache_hit_rate": (cache.stats()["hit_rate"]
                               if cache is not None else 0.0),
            "pinned_bytes": (hotset.pinned_bytes
                             if hotset is not None else 0),
        }

    def cache_stats(self) -> dict:
        """Serving-cache observability with a consistent zero-safe schema
        whether or not either cache level is enabled (and at any point in
        the server lifecycle — empty windows report zeros, never raise)."""
        cache = getattr(self, "_result_cache", None)
        hotset = getattr(self, "_hotset", None)
        out = {
            "enabled": cache is not None or hotset is not None,
            "hits": 0, "misses": 0, "hit_rate": 0.0, "entries": 0,
            "invalidated": 0, "cleared": 0, "rekeyed": 0,
            "evicted_lru": 0, "hit_staleness": 0.0,
            "pinned_bytes": 0, "pinned_clusters": 0, "hot_served": 0,
            "tier_rebuilds": 0,
        }
        if cache is not None:
            s = cache.stats()
            for key in ("hits", "misses", "hit_rate", "entries",
                        "invalidated", "cleared", "rekeyed", "evicted_lru",
                        "hit_staleness"):
                out[key] = s[key]
        if hotset is not None:
            h = hotset.stats()
            out["pinned_bytes"] = h["pinned_bytes"]
            out["pinned_clusters"] = h["pinned_clusters"]
            out["hot_served"] = h["hot_served"]
            out["tier_rebuilds"] = h["rebuilds"]
        return out

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

    ``durability`` (a ``DurabilityConfig``) arms the write-ahead journal,
    cadence checkpoints and constructor-time recovery; with it armed
    ``ingest`` takes no ``draws`` (the journal cannot replay them).
    """

    _STOP = object()

    def __init__(self, cfg: "pipeline.PipelineConfig", server_cfg: ServerConfig,
                 seed: int | None = None, warmup=None, embed_fn=None,
                 engine: Engine | None = None, publish_every: int = 4,
                 queue_max: int = 64,
                 durability: DurabilityConfig | None = None,
                 max_restarts: int = 8, backoff_base_s: float = 0.01,
                 backoff_max_s: float = 1.0, supervise_seed: int = 0,
                 device=None):
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
        # ---- supervision + durability (crash-safe streaming) ----
        self.max_restarts = max_restarts
        self._backoff = (backoff_base_s, backoff_max_s)
        self._jitter = random.Random(supervise_seed)
        self.restarts = 0
        self.quarantined: list[int] = []   # poison-batch seqs (never silent)
        self._attempts: dict[int, int] = {}
        self._quarantine_after = (durability.quarantine_after
                                  if durability is not None else 3)
        self._error_seq: int | None = None
        self._inflight = None              # ingest-thread resume state
        self._inflight_stage = "done"
        self._next_seq = 0                 # non-durable seq counter
        self._ingest_lock = threading.Lock()  # journal order == queue order
        self.recovery_report: dict | None = None
        self._docs_ingested = 0             # ingest-thread private
        self._durable = (DurableIngest(
            durability, cluster_axis=getattr(engine, "ckpt_cluster_axis", 0))
            if durability is not None else None)
        if self._durable is not None and self._durable.needs_recovery():
            self._recover()  # before the first publish: the initial
            #                  snapshot already serves the recovered stream
        # ---- hot-set serving cache (built BEFORE the first publish so
        # no publication can ever race their creation) ----
        self._result_cache = (ResultCache(server_cfg.cache_entries)
                              if server_cfg.cache_entries > 0 else None)
        self._hotset = (HotSet(
            cfg, max_batch=server_cfg.max_batch,
            pin_budget_bytes=int(server_cfg.pin_budget_mb * 2**20),
            capacity=server_cfg.hotset_capacity,
            refresh_every=server_cfg.hotset_refresh,
            min_count=server_cfg.hotset_min_count, device=engine.device)
            if server_cfg.hotset else None)
        # rows whose served routes differed from the route pass's (see
        # the module docstring); 0 wherever the two kernels agree
        self.route_mismatches = 0
        # pending rows whose route order a near-tie left open, so that
        # the route pass could not verify a cached survivor
        self.route_near_ties = 0
        # publish events (version, dirty-cluster array) cross from the
        # ingest thread to the query path through this deque (GIL-atomic
        # append/popleft); the query path applies them IN ORDER up to the
        # snapshot version it pinned, so invalidation can neither run
        # ahead of the snapshot a flush serves from nor miss a publish.
        self._pub_events: collections.deque = collections.deque()
        self._published = self._publish_now()   # queries never see None
        self._published_docs = self._docs_ingested  # recovery is published
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
        the caller thread with the failing batch's sequence number; an
        :class:`~repro_torch.testing.faults.InjectedCrash` escapes
        supervision entirely — the thread dies like a SIGKILL'd process,
        with no final publish/checkpoint/truncation, and only recovery
        from the durable state brings the stream back."""
        while True:
            try:
                self._ingest_run()
                return
            except faults.InjectedCrash:
                return  # simulated process death: no finalization at all
            except BaseException as e:  # surfaced by _check, never dropped
                seq = (self._inflight[0]
                       if isinstance(self._inflight, tuple) else None)
                if (classify_error(e) == "fatal"
                        or self.restarts >= self.max_restarts):
                    self._error_seq = seq
                    self._error = e  # set LAST: _check reads seq after it
                    return
                self.restarts += 1
                reg = obs.metrics()
                if reg is not None:
                    reg.counter("ingest_restarts_total").inc()
                base, cap = self._backoff
                delay = min(cap, base * (2 ** (self.restarts - 1)))
                time.sleep(delay * (1.0 + 0.25 * self._jitter.random()))
                self._on_restart(seq)

    def _ingest_run(self):
        """One supervised incarnation of the ingest loop. Per-batch work
        is a resumable stage machine (admit -> publish -> checkpoint):
        after a mid-batch failure the restart resumes at the failing
        stage, so an applied batch is never ingested twice and a failed
        cadence publish/checkpoint is retried at once."""
        while True:
            item = self._inflight
            if item is None:
                item = self._queue.get()
                self._inflight = item
                self._inflight_stage = "admit"
            if item is self._STOP:
                self._publish()
                if self._durable is not None:  # tail checkpoint + truncate
                    self._checkpoint(blocking=True)
                self._inflight = None
                return
            if isinstance(item, threading.Event):  # sync barrier
                self._publish()
                item.set()
                self._inflight = None
                continue
            seq, x, ids, draws = item
            if self._inflight_stage == "admit":
                faults.fault_point("ingest.admit", seq=seq)
                tr = obs.tracer()
                span = (tr.span("ingest.admit", cat="ingest", seq=seq,
                                batch=int(np.asarray(ids).size))
                        if tr is not None else None)
                with self._dispatch.ingest():   # queued flushes go first
                    pass
                with self._on_ingest_stream():
                    self.engine.ingest(x, ids, draws)
                if span is not None:  # dispatch time (execution is async)
                    span.end()
                self._docs_ingested += int(np.sum(np.asarray(ids) >= 0))
                self._since_publish += 1
                if self._durable is not None:
                    self._durable.batch_applied(seq)
                self._attempts.pop(seq, None)
                self._inflight_stage = "publish"
            if self._inflight_stage == "publish":
                if self._since_publish >= self.publish_every:
                    self._publish()
                self._inflight_stage = "checkpoint"
            if self._inflight_stage == "checkpoint":
                if (self._durable is not None
                        and self._durable.should_checkpoint()):
                    self._checkpoint()
                self._inflight = None
                self._inflight_stage = "done"

    def _on_restart(self, seq: int | None):
        """Post-backoff restart hygiene: poison-batch quarantine and
        serving-cache coherence."""
        # a batch that burned its whole per-batch retry budget at the
        # admit stage is quarantined: dropped from the retry loop ONLY —
        # counted, logged, and remembered so recovery replay skips it too
        if seq is not None and self._inflight_stage == "admit":
            n = self._attempts.get(seq, 0) + 1
            self._attempts[seq] = n
            if n >= self._quarantine_after:
                self.quarantined.append(seq)
                if self._durable is not None:
                    self._durable.quarantined.append(seq)
                self._attempts.pop(seq, None)
                self._inflight = None
                self._inflight_stage = "done"
                reg = obs.metrics()
                if reg is not None:
                    reg.counter("ingest_quarantined_total").inc()
        # cache coherence: clear the result cache at the pinned version
        # and mark the hot tier stale — nothing a failed attempt might
        # have half-published can survive the restart
        if self._result_cache is not None or self._hotset is not None:
            self._pub_events.append((self._snapshot.version, None))

    def _checkpoint(self, blocking: bool = False):
        """Cadence checkpoint from the ingest thread: the host copies
        queue on the ingest stream, the write runs on the store's own
        thread (the journal truncates from its durable callback). A prior
        write failure was counted by the store and left the dirty
        baseline untouched — this save simply covers it too."""
        self._durable.ckpt.poll_error()  # counted; cleared for the retry
        with self._on_ingest_stream():
            self._durable.checkpoint(
                self.engine.checkpoint_state(),
                metadata={"docs_ingested": self._docs_ingested},
                blocking=blocking)

    def _recover(self):
        """Constructor-time recovery: restore the newest checkpoint chain
        and replay the journal tail through the normal ingest path, on
        the ingest stream — bit-identical to the engine that never
        crashed (determinism of ingest + batch-boundary checkpoints).
        Runs before the first publish, so the initial snapshot already
        serves the recovered stream and every cache starts coherent."""
        eng = self.engine
        with self._on_ingest_stream():
            report = self._durable.recover(
                eng.checkpoint_state(),
                lambda x, ids: eng.ingest(x, ids),
                lambda tree, meta: eng.restore_state(tree))
        self.recovery_report = report
        self.quarantined = list(report["quarantined"])
        docs = report["docs_checkpointed"] + report["docs_replayed"]
        self._docs_ingested = docs
        with self._lock:
            self.stats["docs"] = docs

    def _publish(self):
        faults.fault_point("publish")
        # the doc watermark BEFORE publishing: the snapshot holds at
        # least everything ingested up to here
        docs = self._docs_ingested
        reg, tr = obs.metrics(), obs.tracer()
        span = (tr.span("ingest.publish", cat="ingest")
                if tr is not None else None)
        t0 = time.perf_counter()
        with self._dispatch.ingest():   # queued flushes go first
            pass
        pub = self._publish_now()
        info = self.engine.last_publish_info
        # the invalidation event is visible BEFORE the snapshot swap: any
        # flush that pins the new version is guaranteed to find its dirty
        # set queued (a flush still on the old version leaves it queued —
        # version-gated application keeps ordering exact either way)
        if self._result_cache is not None or self._hotset is not None:
            self._pub_events.append(
                (pub.snap.version, info.get("dirty") if info else None))
        self._published = pub        # one reference swap
        self._published_docs = docs
        self._since_publish = 0
        if reg is None and tr is None:
            return
        # publish-time telemetry ONLY: the device-counter fetch below is
        # the one host transfer metrics add, and it runs here on the
        # ingest thread and stream — never on the query path
        pub_ms = (time.perf_counter() - t0) * 1e3
        lag = self.stats["docs"] - docs
        if span is not None:
            span.args["version"] = pub.snap.version
            if info is not None:   # scalars only: the dirty index array
                #                    is not JSON-exportable span material
                span.args.update({key: v for key, v in info.items()
                                  if key != "dirty"})
            span.end()
            tr.counter("freshness", {"lag_docs": lag,
                                     "snapshot_version": pub.snap.version})
        if reg is not None:
            reg.counter("publish_total").inc()
            if info is not None:
                reg.counter(f"publish_{info['mode']}_total").inc()
            reg.histogram("publish_latency_ms", unit="ms").observe(pub_ms)
            reg.gauge("publish_lag_docs").set(lag)
            reg.gauge("snapshot_version").set(pub.snap.version)
            with self._on_ingest_stream():
                counters = self.engine.device_counters()
            reg.set_many("pipeline_", counters,
                         help="device pipeline counters (publish fetch)")

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

        With durability armed the batch is journaled (appended + fsync'd)
        BEFORE it is enqueued, under one producer lock, so journal
        sequence order IS queue order — the property replay bit-identity
        rests on. The ``ingest.enqueue`` fault point fires before the
        journal append: a producer-side failure means the batch was never
        acknowledged durable, so nothing is ever silently lost.

        ``draws`` (a test hook) are the heavy-hitter's per-arrival draws
        for this batch (``heavy_hitter.update_batch``); None draws them
        from the engine's generator. The journal cannot replay them, so
        a durable server refuses them."""
        if self._closed:
            raise RuntimeError(
                "server is closed: ingest() after close() would never "
                "be applied")
        if draws is not None and self._durable is not None:
            raise ValueError("a durable server takes no draws: journal "
                             "replay draws from the engine's generator")
        self._check()
        x = np.asarray(embeddings)
        ids = np.asarray(doc_ids)
        tr = obs.tracer()
        span = (tr.span("ingest.enqueue", cat="ingest", batch=int(ids.size))
                if tr is not None else None)
        with self._ingest_lock:
            faults.fault_point("ingest.enqueue")
            if self._durable is not None:
                seq = self._durable.record(x, ids)
            else:
                seq = self._next_seq
                self._next_seq += 1
            self._put((seq, x, ids, draws), timeout)
        if span is not None:
            span.args["seq"] = seq
            span.end()
        # live rows only (doc_id < 0 is padding), as _docs_ingested counts
        live = int(np.sum(ids >= 0))
        with self._lock:
            self.stats["docs"] += live
        reg = obs.metrics()
        if reg is not None:
            reg.counter("ingest_docs_enqueued_total").inc(live)
            reg.gauge("ingest_queue_depth").set(self._queue.qsize())

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

    def _pin(self, pub: _Published):
        """Make the query stream wait for ``pub``'s publish and mark the
        snapshot's tensors as used there (no-op on the CPU)."""
        if pub.ready is not None:
            stream = torch.cuda.current_stream(self.engine.device)
            stream.wait_event(pub.ready)
            for t in _tensors(pub.snap):
                t.record_stream(stream)

    def _query_batch(self, q: np.ndarray, plan=None):
        self._check()
        pub = self._published         # pin ONE snapshot for the whole batch
        self._last_snapshot = pub.snap
        if self._result_cache is not None or self._hotset is not None:
            return self._query_batch_cached(pub, q, plan)
        with self._dispatch.query():
            self._pin(pub)
            return self.engine.query_snapshot(
                pub.snap, q, self.scfg.topk, two_stage=self.scfg.two_stage,
                nprobe=self.scfg.nprobe, plan=plan)

    def _query_batch_cached(self, pub: _Published, q: np.ndarray, plan=None):
        """Two-level cached serving for one flush, pinned to ``pub``.

        1. apply queued publications up to the pinned version (precise
           result-cache invalidation + hot-tier staleness);
        2. route-free exact hits: entries whose routes were verified at
           the pinned version answer immediately — an all-hit flush never
           touches the device;
        3. ONE route pass over the *pending* sub-batch
           (``stages.route_witnessed``, the ``mips`` kernel) yields ordered
           routes — the exactness witness for entries that survived a
           publish (where no near-tie leaves their order open), the
           hot-tier coverage test, and the heavy-hitter observation (one
           ``heavy_hitter`` launch);
        4. remaining misses split into hot-covered (the ``serve`` kernel
           over the pinned tier) and cold (over the snapshot's store),
           served as they are (no padding: the kernel's answer for a
           query does not depend on the sub-batch), checked against the
           route pass's routes, and inserted back into the cache.

        Every answer is bit-identical to what the uncached path returns
        for the same snapshot. Returns host tensors."""
        snap = pub.snap
        cache, hotset = self._result_cache, self._hotset
        k = self.scfg.topk
        nprobe_eff, depth = _resolve_plan(plan, self.scfg.nprobe)
        store_depth = self.cfg.store_depth
        depth_eff = store_depth if depth is None else min(depth, store_depth)
        plan_key = (plan.key if plan is not None
                    else f"np{nprobe_eff}xd{depth_eff}")
        while self._pub_events and self._pub_events[0][0] <= snap.version:
            version, dirty = self._pub_events.popleft()
            if cache is not None:
                cache.on_publish(version, dirty)
            if hotset is not None:
                hotset.note_publish(version, dirty)
        B = q.shape[0]
        scores = np.full((B, k), -np.inf, np.float32)
        rows = np.full((B, k), -1, np.int32)
        ids = np.full((B, k), -1, np.int32)
        labels = np.full((B, k), -1, np.int32)
        qbytes = [q[i].tobytes() for i in range(B)]
        pend = []   # needs routing: unverified survivor or absent entry
        for i in range(B):
            ans = (cache.peek_exact(qbytes[i], plan_key, snap.version)
                   if cache is not None else None)
            if ans is not None:
                scores[i], rows[i], ids[i], labels[i] = ans
            else:
                pend.append(i)
        n_miss = 0
        hot_served = 0
        if pend:
            pidx = np.asarray(pend)
            with self._dispatch.query():
                self._pin(pub)
                if hotset is not None:
                    hotset.sync(snap)
                routes, clear = stages.route_witnessed(
                    self.cfg.index, snap.index, snap.route_labels,
                    self.engine._queries(q[pidx]), nprobe_eff)
            self.route_near_ties += int(np.sum(~clear))
            miss_pos = []
            for j, i in enumerate(pend):
                # a route order a near-tie leaves open witnesses nothing
                ans = (cache.lookup(qbytes[i], plan_key, snap.version,
                                    routes[j] if clear[j] else None)
                       if cache is not None else None)
                if ans is not None:
                    scores[i], rows[i], ids[i], labels[i] = ans
                else:
                    miss_pos.append(j)
            # hot-set tracking observes the routed sub-batch only: the
            # route-free hits above are exactly the queries that don't
            # need the tier, so the counter keeps seeing the traffic the
            # tier exists for
            if hotset is not None:
                hotset.observe(routes)
            n_miss = len(miss_pos)
        if n_miss:
            mpos = np.asarray(miss_pos)
            midx = pidx[mpos]
            hot_mask = (hotset.covered(routes[mpos]) if hotset is not None
                        else np.zeros((mpos.size,), bool))
            hot_served = int(np.sum(hot_mask))
            served = np.zeros((mpos.size,), bool)  # routes agree with the pass
            out_h = None
            with self._dispatch.query():
                if hot_mask.any():
                    out_h = hotset.serve(
                        snap, self.engine._queries(q[midx[hot_mask]]), k,
                        nprobe_eff, depth_eff)
            if out_h is not None:
                sc, rw_t, di, cl_t, rt_t = (a.cpu().numpy() for a in out_h)
                rw, cl = hotset.remap(rw_t, cl_t)
                ok = np.all(hotset.remap_routes(rt_t) == routes[mpos[hot_mask]],
                            axis=1)
                hsel = np.nonzero(hot_mask)[0][ok]
                sel = midx[hsel]
                scores[sel], rows[sel] = sc[ok], rw[ok]
                ids[sel], labels[sel] = di[ok], cl[ok]
                served[hsel] = True
                self.route_mismatches += int(np.sum(~ok))
            cold = np.nonzero(~served)[0]
            if cold.size:
                with self._dispatch.query():
                    out_c = routed_query(
                        self.cfg, snap.index, snap.route_labels, snap.store,
                        self.engine._queries(q[midx[cold]]), k, nprobe_eff,
                        depth)
                sc, rw, di, cl, rt = (a.cpu().numpy() for a in out_c)
                sel = midx[cold]
                scores[sel], rows[sel] = sc, rw
                ids[sel], labels[sel] = di, cl
                ok = np.all(rt == routes[mpos[cold]], axis=1)
                self.route_mismatches += int(np.sum(~ok & ~hot_mask[cold]))
                served[cold[ok]] = True
            if cache is not None:
                for j, i in zip(mpos[served], midx[served]):
                    cache.insert(qbytes[i], plan_key, snap.version,
                                 routes[j], (scores[i].copy(),
                                             rows[i].copy(), ids[i].copy(),
                                             labels[i].copy()))
        reg = obs.metrics()
        if reg is not None:
            reg.counter("cache_hits_total").inc(B - n_miss)
            reg.counter("cache_misses_total").inc(n_miss)
            if cache is not None:
                reg.gauge("cache_entries").set(len(cache))
            if hotset is not None:
                reg.counter("hotset_served_total").inc(hot_served)
                reg.gauge("hotset_pinned_bytes").set(hotset.pinned_bytes)
                reg.gauge("hotset_pinned_clusters").set(
                    hotset.stats()["pinned_clusters"])
        return tuple(torch.from_numpy(a) for a in (scores, rows, ids, labels))

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
        """Stop the ingest thread after a final publish (and, durable, a
        tail checkpoint); idempotent once the thread has stopped (a
        timed-out close can be retried)."""
        if self._closed:
            return
        if not self._stop_sent and self._thread.is_alive():
            self._put(self._STOP, timeout)
            self._stop_sent = True
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("ingest thread did not stop in time")
        self._closed = True
        if self._durable is not None:
            self._durable.close()
        self._check()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ accounting
    def state_memory_bytes(self) -> int:
        """Engine state bytes PLUS the hot tier's resident pin bytes —
        the serving-side number charged against the paper's 150 MB
        envelope."""
        base = self.engine.state_memory_bytes()
        return base + (self._hotset.pinned_bytes
                       if self._hotset is not None else 0)

    def robustness_stats(self) -> dict:
        """Supervision + durability accounting. The schema is CONSTANT
        whether or not durability is armed (zeros / None / empty when
        disabled) and at every point of the server lifecycle."""
        out = {
            "restarts": self.restarts,
            "max_restarts": self.max_restarts,
            "quarantined": list(self.quarantined),
            "error_seq": self._error_seq,
            "durable": self._durable is not None,
            "recovery": self.recovery_report,
            "journal_last_seq": -1,
            "journal_segments": 0,
            "journal_disk_bytes": 0,
            "journal_lag_batches": 0,
            "checkpoint_seq": None,
            "checkpoint_age_batches": 0,
            "checkpoint_saves": {"full": 0, "delta": 0, "failed": 0},
            "checkpoint_bytes": {"full": 0, "delta": 0},
        }
        if self._durable is not None:
            s = self._durable.stats()
            for key in ("journal_last_seq", "journal_segments",
                        "journal_disk_bytes", "journal_lag_batches",
                        "checkpoint_seq", "checkpoint_age_batches",
                        "checkpoint_saves", "checkpoint_bytes"):
                out[key] = s[key]
        return out

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
