"""The load generator: one general generator for every traffic file.

Queries arrive open loop (Poisson, at the file's rate) and are timed from
the moment each was due, so a stall also delays the queries behind it.
Ingest is either open loop (batches at a fixed spacing) or closed loop
(the next batch is offered as soon as the server's bounded queue takes
it). One thread submits, ingests and calls the front end's flush, as a
deployment's request loop would; the server's own ingest thread applies
the batches. Every call into the program is wrapped in a span of the
benchmark's own (name, start, end) on ``time.perf_counter``.
"""
from __future__ import annotations

import threading
import time

import numpy as np

clock = time.perf_counter


class Versions:
    """The batches applied at each published version, from the order of
    the calls: the server publishes once at construction, after every
    ``every`` applied batches, and at each ``sync`` and at ``close``."""

    def __init__(self, every: int):
        self.every = every
        self.batches = 0
        self.since = 0
        self.at = [0, 0]          # version 0 (never served), version 1

    def batch(self):
        self.batches += 1
        self.since += 1
        if self.since >= self.every:
            self._publish()

    def _publish(self):
        self.at.append(self.batches)
        self.since = 0

    sync = close = _publish


class Feed:
    """The cell's batches in order (``cell.Inputs.batch``), each with the
    counter's draws for it."""

    def __init__(self, inputs, versions: Versions):
        self.inputs = inputs
        self.next = 0
        self.versions = versions

    def offer(self, server, spans):
        x, lo, u = self.inputs.batch(self.next)
        t = clock()
        server.ingest(x, np.arange(lo, lo + x.shape[0], dtype=np.int32),
                      draws={"uniforms": u})
        spans.append(("bench.ingest", t, clock()))
        self.next += 1
        self.versions.batch()


def serve_window(server, feed: Feed, t0: float, seconds: float, q_due,
                 pool, q_idx, b_due, sample, max_wait_s: float, spans,
                 flushes, grace_s: float = 60.0) -> dict:
    """Open-loop queries (due times ``t0 + q_due``, the vectors
    ``pool[q_idx]``) with open-loop ingest at ``t0 + b_due``; flushes
    whenever the front end says one is due, each noted in ``flushes`` as
    (start, end, queries). Returns the per-query record; the answers of
    the queries in ``sample`` (a bool mask) are kept."""
    nq, nb = q_due.shape[0], b_due.shape[0]
    due, bdue = t0 + q_due, t0 + b_due
    submitted = np.full(nq, np.nan)
    answered = np.full(nq, np.nan)
    fstart = np.full(nq, np.nan)
    version = np.full(nq, -1, np.int64)
    kept = {}
    base = None
    iq = ib = n_ans = 0
    t_end = t0 + seconds
    while True:
        now = clock()
        if iq < nq and due[iq] <= now:
            s0 = now
            while iq < nq and due[iq] <= now:
                t = server.submit(pool[q_idx[iq]])
                submitted[iq] = clock()
                if base is None:
                    base = t - iq
                iq += 1
            spans.append(("bench.submit", s0, clock()))
        if ib < nb and bdue[ib] <= now:
            feed.offer(server, spans)
            ib += 1
        fs = clock()
        outs = server.serve_round()
        if outs:
            fe = clock()
            spans.append(("bench.flush", fs, fe))
            flushes.append((fs, fe, len(outs)))
            for o in outs:
                j = o["ticket"] - base
                answered[j], fstart[j] = fe, fs
                version[j] = o["snapshot_version"]
                if sample[j]:
                    kept[j] = (o["doc_ids"].copy(), o["scores"].copy(),
                               o["clusters"].copy())
            n_ans += len(outs)
            continue
        if iq >= nq and ib >= nb and n_ans >= iq:
            if now >= t_end:
                break
        if now >= t_end + grace_s:
            break
        nxt = [t_end]
        if iq < nq:
            nxt.append(due[iq])
        if ib < nb:
            nxt.append(bdue[ib])
        if n_ans < iq:
            nxt.append(submitted[n_ans] + max_wait_s)
        dt = min(nxt) - clock()
        if dt > 0:
            time.sleep(min(dt, 0.001))
    return {"due": due, "submitted": submitted, "answered": answered,
            "flush_start": fstart, "version": version, "answers": kept,
            "t_end": t_end}


def ingest_window(server, feed: Feed, t0: float, seconds: float,
                  spans) -> dict:
    """Closed-loop ingest: offer batches until the window closes; the
    documents the ingest thread applied are read at both ends of the
    window by a thread of its own."""
    t_end = t0 + seconds
    reads = {}

    def sample():
        for key, at in (("start", t0), ("end", t_end)):
            dt = at - clock()
            if dt > 0:
                time.sleep(dt)
            reads[key] = (clock(), server.freshness_stats()["docs_ingested"])

    th = threading.Thread(target=sample, name="bench-ingest-clock")
    th.start()
    try:
        while clock() < t0:
            time.sleep(0.0005)
        offered = 0
        while clock() < t_end:
            feed.offer(server, spans)
            offered += 1
    finally:
        th.join(timeout=seconds + 60.0)
    if th.is_alive():
        raise RuntimeError("the window's clock thread did not end")
    (ta, da), (tb, db) = reads["start"], reads["end"]
    return {"docs": db - da, "window_s": tb - ta, "offered": offered,
            "t_end": t_end}
