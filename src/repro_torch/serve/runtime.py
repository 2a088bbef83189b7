"""Micro-batching query front end shared by the port's servers.

``QueryFrontend`` queues queries with monotone tickets, flushes them in
batches of up to ``max_batch`` (or after ``max_wait_ms``), answers each
batch through the subclass's ``_query_batch`` and keeps bounded latency
windows; ``drain()`` loops ``flush()`` so no pending query is dropped.

Not yet ported: the background-ingest ``AsyncServer``, adaptive
degradation (ROADMAP A6), the result cache and hot set (ROADMAP A6),
and the metrics/trace spans (ROADMAP A6, with ``obs``).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable

import numpy as np

from repro_torch.core import pipeline
from repro_torch.engine.plan import PlanSpace


@dataclasses.dataclass
class ServerConfig:
    max_batch: int = 64
    max_wait_ms: float = 2.0
    topk: int = 10
    two_stage: bool = False    # routed two-stage retrieval (document store)
    nprobe: int = 8            # clusters routed per query when two_stage
    latency_window: int = 1024  # per-batch latencies kept for p50/p99
    # the fields below arm parts of the serving runtime the port has not
    # reached yet; a server built with them raises NotImplementedError
    adaptive: bool = False
    cache_entries: int = 0
    hotset: bool = False


def _refuse_unported(scfg: ServerConfig) -> None:
    for name, on in (("adaptive", scfg.adaptive),
                     ("cache_entries", scfg.cache_entries),
                     ("hotset", scfg.hotset)):
        if on:
            raise NotImplementedError(
                f"ServerConfig.{name} arrives with the port's serving "
                "runtime (ROADMAP A6: AsyncServer, executor, result cache, "
                "hot set)")


class QueryFrontend:
    """Subclasses implement ``_query_batch(q, plan) -> (scores, rows, ids,
    clusters)``. Each answer carries its ``ticket``."""

    def __init__(self, cfg: "pipeline.PipelineConfig", server_cfg: ServerConfig,
                 embed_fn: Callable[[list], np.ndarray] | None = None):
        _refuse_unported(server_cfg)
        self._full_plan = None
        if server_cfg.two_stage:  # fail at construction, not first flush
            assert cfg.store_depth > 0, \
                "two_stage serving needs a PipelineConfig with store_depth > 0"
            assert server_cfg.topk <= server_cfg.nprobe * cfg.store_depth, \
                "topk must be <= nprobe * store_depth"
            assert server_cfg.nprobe <= cfg.hh.bmax(), \
                "nprobe must be <= the prototype index capacity"
            self._full_plan = PlanSpace(
                nprobe=server_cfg.nprobe, depth=cfg.store_depth,
                k=server_cfg.topk).full
        self.cfg = cfg
        self.scfg = server_cfg
        self.embed_fn = embed_fn
        self._pending: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._next_ticket = 0
        self._lat_sum = 0.0
        self.stats = {
            "queries": 0, "docs": 0, "batches": 0,
            "query_latency_ms":
                collections.deque(maxlen=server_cfg.latency_window),
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

    def flush(self) -> list[dict]:
        """Answer up to ``max_batch`` queued queries as one batch."""
        with self._lock:
            if not self._pending:
                return []
            batch = [self._pending.popleft()
                     for _ in range(min(len(self._pending),
                                        self.scfg.max_batch))]
        t0 = time.perf_counter()
        raw = [b["q"] for b in batch]
        q = self.embed_fn(raw) if self.embed_fn is not None else np.stack(raw)
        scores, _, ids, labels = self._query_batch(
            np.asarray(q, np.float32), self._full_plan)
        # one host transfer per output
        scores, ids, labels = (scores.cpu().numpy(), ids.cpu().numpy(),
                               labels.cpu().numpy())
        lat = (time.perf_counter() - t0) * 1e3
        out = [{
            "ticket": b["ticket"],
            "scores": scores[i],
            "doc_ids": ids[i],
            "clusters": labels[i],
            "enqueue_to_answer_ms": (time.perf_counter() - b["t"]) * 1e3,
        } for i, b in enumerate(batch)]
        with self._lock:
            self.stats["queries"] += len(batch)
            self.stats["batches"] += 1
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
        enqueue->answer latency (``answer_p*_ms``)."""
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
        }

    def _query_batch(self, q: np.ndarray, plan=None):
        raise NotImplementedError
