"""Periodic serving reporter: one compact line per interval, one summary.

One formatter over the structured serving sources —
``latency_stats()`` (batch + per-query windows), ``freshness_stats()``
(doc lag + wall-clock snapshot age), and the device pipeline counters
published into the metrics registry — so the launcher, benchmarks, and
any operator tail the same numbers the exported JSON carries.
"""
from __future__ import annotations

from repro_torch import obs


def _fmt(v, digits=2) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{digits}f}"
    return str(v)


class Reporter:
    """Periodic one-line serving report + final summary for a server
    built on ``serve.runtime.QueryFrontend`` (sync or async)."""

    def __init__(self, server, every: int = 10, out=print):
        self.server = server
        self.every = max(1, every)
        self.out = out

    # ------------------------------------------------------------ periodic
    def round_done(self, i: int) -> None:
        if (i + 1) % self.every == 0:
            self.out(self.line(round_idx=i + 1))

    def line(self, round_idx: int | None = None) -> str:
        lat = self.server.latency_stats()
        parts = []
        if round_idx is not None:
            parts.append(f"round={round_idx}")
        parts += [
            f"answered={self.server.stats['queries']}",
            f"docs={self.server.stats['docs']}",
            f"q_p50={_fmt(lat['answer_p50_ms'])}ms",
            f"q_p99={_fmt(lat['answer_p99_ms'])}ms",
            f"batch_p50={_fmt(lat['p50_ms'])}ms",
        ]
        fresh = getattr(self.server, "freshness_stats", None)
        if fresh is not None:
            f = fresh()
            parts.append(f"snap=v{f['snapshot_version']}")
            parts.append(f"lag={f['lag_docs']}docs")
            if f.get("snapshot_age_s") is not None:
                parts.append(f"age={_fmt(f['snapshot_age_s'])}s")
        cache = getattr(self.server, "cache_stats", None)
        if cache is not None:
            c = cache()
            if c["enabled"]:
                parts.append(f"hit={_fmt(c['hit_rate'])}")
                parts.append(f"pin={c['pinned_bytes'] // 1024}KiB")
        reg = obs.metrics()
        if reg is not None:
            snap = reg.snapshot()["gauges"]
            rate = snap.get("pipeline_admit_rate")
            if rate is not None:
                parts.append(f"admit={_fmt(rate)}")
            occ = snap.get("pipeline_store_fill")
            if occ is not None:
                parts.append(f"store_fill={_fmt(occ)}")
        return "[obs] " + " ".join(parts)

    # ------------------------------------------------------------- summary
    def final(self, submitted: int, answered: int) -> None:
        lat = self.server.latency_stats()
        self.out(f"docs ingested    : {self.server.stats['docs']}")
        self.out(f"queries answered : {answered} / {submitted} submitted")
        self.out(
            f"batch latency ms : mean={lat['mean_ms']:.2f} "
            f"p50={lat['p50_ms']:.2f} p99={lat['p99_ms']:.2f}")
        self.out(
            f"query  e2e   ms  : p50={lat['answer_p50_ms']:.2f} "
            f"p90={lat['answer_p90_ms']:.2f} "
            f"p99={lat['answer_p99_ms']:.2f} "
            f"(window={lat['answer_window']})")
        fresh = getattr(self.server, "freshness_stats", None)
        if fresh is not None:
            f = fresh()
            age = (f"{f['snapshot_age_s']:.3f}s"
                   if f.get("snapshot_age_s") is not None else "n/a")
            self.out(f"freshness        : snapshot v{f['snapshot_version']} "
                     f"lag={f['lag_docs']} docs age={age}")
        cache = getattr(self.server, "cache_stats", None)
        if cache is not None:
            c = cache()
            if c["enabled"]:
                self.out(
                    f"serving cache    : hit_rate={c['hit_rate']:.3f} "
                    f"hits={c['hits']} misses={c['misses']} "
                    f"invalidated={c['invalidated']} "
                    f"staleness={c['hit_staleness']:.2f} "
                    f"pin={c['pinned_bytes'] // 1024}KiB "
                    f"hot_served={c['hot_served']}")
