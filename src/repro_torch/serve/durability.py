"""Crash-safe streaming, as far as the port has it: the supervisor's
error classification (``classify_error``), which ``AsyncServer``'s
ingest loop uses to decide between a restart and surfacing the error.

The write-ahead journal, the checkpoint store and recovery
(``IngestJournal``, ``CheckpointStore``, ``DurableIngest``) arrive with
the rest of the serving runtime (ROADMAP A6); until then ``AsyncServer(durability=...)`` raises
``NotImplementedError``.
"""
from __future__ import annotations

_TRANSIENT_TYPES = (TimeoutError, ConnectionError, BrokenPipeError)


def classify_error(e: BaseException) -> str:
    """``"transient"`` (supervisor retries within its bounded budget) or
    ``"fatal"`` (surface to the caller). An exception opts into either
    class with a truthy/falsy ``transient`` attribute; otherwise only a
    small allowlist of environmental errors is retried — everything
    else (shape errors, assertion failures, ...) is a bug and must not
    be masked by retry."""
    marked = getattr(e, "transient", None)
    if marked is not None:
        return "transient" if marked else "fatal"
    return "transient" if isinstance(e, _TRANSIENT_TYPES) else "fatal"
