"""Process-wide metrics registry: counters, gauges, log-bucket histograms.

Design constraints, in order:

  1. **Zero cost when disabled.** Instrumentation sites hold no metric
     objects; they fetch the active registry once per *batch* (never per
     item) via ``obs.metrics()`` and skip everything when it is ``None``.
     Disabled serving therefore performs no metric calls, no allocations
     and no device work on the query hot path — pinned by
     ``tests/test_torch_obs.py``.
  2. **Exact under threads.** The serving runtime records from the query
     thread, the ingest thread, and benchmark harnesses concurrently; every
     mutation takes the instrument's lock, so totals are exact (no lost
     ``+=`` interleavings). The locks are uncontended in practice — one
     observation per batch/publish — so the enabled overhead stays well
     under the 2% serving budget.
  3. **Fixed memory.** Histograms use a fixed number of log-scale buckets
     (no per-observation storage): percentile reads are bucket-resolution
     estimates, exact count/sum/min/max. The whole registry is O(#metrics).

Export formats: ``to_json()`` (benchmark dumps, ``--metrics-json``) and
``to_prometheus()`` (the standard text exposition format, scrapeable).
"""
from __future__ import annotations

import json
import math
import threading
import time


class Counter:
    """Monotone counter (exact under concurrent ``inc``)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket log-scale histogram.

    Bucket ``i`` covers ``[lo * growth^i, lo * growth^(i+1))``; values
    below ``lo`` land in bucket 0, values at or above ``hi`` in the last
    (overflow) bucket. The bucket index is one ``log`` — no search, no
    allocation — so ``observe`` is safe on latency paths.
    """

    __slots__ = ("name", "help", "unit", "lo", "hi", "nbuckets", "_log_lo",
                 "_log_growth", "_lock", "_buckets", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, name: str, help: str = "", unit: str = "",
                 lo: float = 1e-3, hi: float = 1e5, nbuckets: int = 64):
        assert lo > 0 and hi > lo and nbuckets >= 2
        self.name = name
        self.help = help
        self.unit = unit
        self.lo = lo
        self.hi = hi
        self.nbuckets = nbuckets
        self._log_lo = math.log(lo)
        # nbuckets - 1 geometric buckets span [lo, hi); the last is overflow
        self._log_growth = (math.log(hi) - self._log_lo) / (nbuckets - 1)
        self._lock = threading.Lock()
        self._buckets = [0] * nbuckets
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = int((math.log(v) - self._log_lo) / self._log_growth)
        return min(i, self.nbuckets - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._index(v) if v == v else self.nbuckets - 1  # NaN -> overflow
        with self._lock:
            self._buckets[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def bucket_upper(self, i: int) -> float:
        if i >= self.nbuckets - 1:
            return math.inf
        return math.exp(self._log_lo + (i + 1) * self._log_growth)

    def percentile(self, q: float) -> float:
        """Bucket-resolution percentile estimate (upper bound of the
        bucket holding the q-quantile observation); exact at the ends
        via the tracked min/max."""
        with self._lock:
            count, buckets = self._count, list(self._buckets)
            mn, mx = self._min, self._max
        if count == 0:
            return 0.0
        if q <= 0:
            return mn
        if q >= 100:
            return mx
        rank = q / 100.0 * count
        run = 0
        for i, b in enumerate(buckets):
            run += b
            if run >= rank:
                return min(self.bucket_upper(i), mx)
        return mx

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            mn = self._min if self._count else 0.0
            mx = self._max if self._count else 0.0
            buckets = list(self._buckets)
        out = {
            "count": count, "sum": total,
            "mean": total / count if count else 0.0,
            "min": mn, "max": mx,
            "p50": 0.0, "p90": 0.0, "p99": 0.0,
            "unit": self.unit,
        }
        if count:
            out["p50"] = self.percentile(50)
            out["p90"] = self.percentile(90)
            out["p99"] = self.percentile(99)
        # non-empty buckets only, as (upper_bound, count) pairs
        out["buckets"] = [
            (self.bucket_upper(i), b) for i, b in enumerate(buckets) if b]
        return out


class Registry:
    """Named instruments, created on first use (idempotent by name).

    ``counter``/``gauge``/``histogram`` return the existing instrument
    when the name is already registered, so instrumentation sites never
    coordinate — they just name what they record.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self.created_at = time.time()

    def _get_or_make(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            assert isinstance(m, cls), \
                f"metric {name!r} already registered as {type(m).__name__}"
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  lo: float = 1e-3, hi: float = 1e5,
                  nbuckets: int = 64) -> Histogram:
        return self._get_or_make(name, Histogram, help=help, unit=unit,
                                 lo=lo, hi=hi, nbuckets=nbuckets)

    def set_many(self, prefix: str, values: dict, help: str = "") -> None:
        """Gauge-set a dict of scalars under ``prefix_<key>`` — the
        one-call sink for device-counter fetches at publish time."""
        for key, v in values.items():
            self.gauge(f"{prefix}{key}", help=help).set(float(v))

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """Plain-dict dump of every instrument (stable shapes per kind)."""
        with self._lock:
            items = sorted(self._metrics.items())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.snapshot()
            else:
                out["histograms"][name] = m.snapshot()
        return out

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(
            {"exported_at": time.time(), **self.snapshot()}, indent=indent)

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (untyped labels-free v0.0.4)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: list[str] = []
        for name, m in items:
            pname = name.replace(".", "_").replace("-", "_")
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value:g}")
            else:
                snap = m.snapshot()
                lines.append(f"# TYPE {pname} histogram")
                run = 0
                for le, b in snap["buckets"]:
                    run += b
                    le_s = "+Inf" if math.isinf(le) else f"{le:g}"
                    lines.append(f'{pname}_bucket{{le="{le_s}"}} {run}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {snap["count"]}')
                lines.append(f"{pname}_sum {snap['sum']:g}")
                lines.append(f"{pname}_count {snap['count']}")
        return "\n".join(lines) + "\n"
