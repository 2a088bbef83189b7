"""End-to-end telemetry: metrics registry, span tracing, device counters.

The subsystem has ONE on/off contract, designed so the disabled state is
free on serving hot paths:

  * ``obs.metrics()`` / ``obs.tracer()`` return the active
    :class:`~repro_torch.obs.metrics.Registry` /
    :class:`~repro_torch.obs.trace.Tracer` or ``None`` when disabled;
  * instrumentation sites fetch them **once per batch / publish**, never
    per item, and skip all recording when disabled — no metric calls, no
    allocations, no device work on the per-query path (pinned by
    ``tests/test_torch_obs.py``);
  * device-side pipeline counters (``engine.stages.pipeline_counters``)
    are fetched as one small host transfer **per publish only** — never
    per query batch — so enabling metrics adds zero device syncs to the
    query path.

Enable programmatically (``obs.enable()``) or with ``REPRO_OBS=1`` in the
environment.

The reference's ``count_kernel_trace`` counts jit traces of its kernel
dispatchers (a compile-churn signal). The port traces and compiles
nothing per shape — its kernels are built once per process — so it has
no counterpart here.
"""
from __future__ import annotations

import os
import threading

from repro_torch.obs.metrics import Counter, Gauge, Histogram, Registry
from repro_torch.obs.trace import Tracer, validate_chrome_trace

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Tracer",
    "validate_chrome_trace", "enable", "disable", "enabled", "metrics",
    "tracer",
]

_lock = threading.Lock()
_registry: Registry | None = None
_tracer: Tracer | None = None


def enable(metrics: bool = True, trace: bool = True,
           max_trace_events: int = 200_000) -> tuple[Registry | None,
                                                     Tracer | None]:
    """Turn telemetry on (idempotent; keeps existing instruments/events).
    Returns the active (registry, tracer) — either may be ``None`` when
    that half stays disabled."""
    global _registry, _tracer
    with _lock:
        if metrics and _registry is None:
            _registry = Registry()
        if trace and _tracer is None:
            _tracer = Tracer(max_events=max_trace_events)
        return _registry, _tracer


def disable() -> None:
    """Drop the registry and tracer — instrumentation reverts to the
    no-op fast path."""
    global _registry, _tracer
    with _lock:
        _registry = None
        _tracer = None


def enabled() -> bool:
    return _registry is not None or _tracer is not None


def metrics() -> Registry | None:
    """The active metrics registry, or ``None`` (disabled fast path)."""
    return _registry


def tracer() -> Tracer | None:
    """The active span tracer, or ``None`` (disabled fast path)."""
    return _tracer


if os.environ.get("REPRO_OBS", "0") == "1":  # pragma: no cover - env hook
    enable()
