"""Deterministic fault injection for the streaming runtime.

The runtime and durability layer call :func:`fault_point` at NAMED sites;
with no plan armed the call is a single ``is None`` check, so production
paths pay nothing. A :class:`FaultPlan` (armed via the :func:`inject`
context manager or the ``REPRO_FAULTS`` env var — same machinery for
tests, CI, and benchmarks) makes chosen hits misbehave deterministically:
the Nth hit of a point fires, every time, for every harness.

Named points (the full set the suite asserts over):

  ===================  ====================================================
  ``ingest.admit``     ingest thread, before the engine applies a batch
  ``ingest.enqueue``   producer side, before the stream queue ``put``
  ``publish``          ingest thread, before a snapshot publication
  ``checkpoint.write`` durability layer, inside the checkpoint file write
  ``replay``           recovery, before each journal batch is re-ingested
  ===================  ====================================================

Modes:

  * ``raise``  — raise :class:`InjectedFault` (transient: the supervisor
    must recover it within its bounded retry budget);
  * ``fatal``  — raise :class:`InjectedFatal` (non-transient: the
    supervisor must NOT retry — the error surfaces to the caller);
  * ``stall``  — sleep ``stall_s`` (the hit then proceeds normally);
  * ``crash``  — raise :class:`InjectedCrash`, a ``BaseException`` that
    escapes all supervision: the ingest thread dies on the spot with no
    final publish/checkpoint/truncation, i.e. a simulated process kill.
    Recovery from the durable state is the only way back.

Spec strings (env + CLI): ``point:mode@at`` or ``point:mode@atxcount``
joined by commas — ``REPRO_FAULTS="ingest.admit:raise@3x2,publish:stall@1"``
fires a transient raise on admit hits 3 and 4 and stalls the first
publish. ``at`` is 1-based; ``count=0`` means "every hit from ``at`` on".

Determinism: firing depends only on per-point hit counters (reset when a
plan is armed). ``seed`` exists for harnesses that want a shared seeded
RNG next to the plan (e.g. jittered stall lengths); nothing in the
default modes consumes entropy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

_VALID_MODES = ("raise", "fatal", "stall", "crash")

POINTS = ("ingest.admit", "ingest.enqueue", "publish", "checkpoint.write",
          "replay")


class InjectedFault(RuntimeError):
    """A transient injected failure — supervisors are expected to retry."""

    transient = True


class InjectedFatal(RuntimeError):
    """A non-transient injected failure — supervisors must surface it."""

    transient = False


class InjectedCrash(BaseException):
    """Simulated process death: escapes ``except Exception`` supervision
    so the faulted thread dies exactly like a SIGKILL'd host — no final
    publish, no checkpoint, no journal truncation."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    point: str
    mode: str = "raise"   # raise | fatal | stall | crash
    at: int = 1           # 1-based hit index that starts firing
    count: int = 1        # consecutive firing hits (0 = every hit >= at)
    stall_s: float = 0.05

    def __post_init__(self):
        assert self.mode in _VALID_MODES, f"unknown fault mode {self.mode!r}"
        assert self.at >= 1 and self.count >= 0

    def fires(self, hit: int) -> bool:
        if hit < self.at:
            return False
        return self.count == 0 or hit < self.at + self.count

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        """``point:mode@at[xcount]`` (``@at`` optional, default 1)."""
        point, _, rest = spec.strip().partition(":")
        assert point and rest, f"bad fault spec {spec!r}"
        mode, _, when = rest.partition("@")
        at, count = 1, 1
        if when:
            first, _, times = when.partition("x")
            at = int(first)
            count = int(times) if times else 1
        return cls(point=point, mode=mode, at=at, count=count)


class FaultPlan:
    """Armed fault set + exact per-point hit/fire accounting.

    ``hits(point)`` counts every arrival at the point while the plan was
    armed; ``fired(point)`` counts the hits that actually misbehaved —
    the numbers the fault suite asserts against supervisor counters.
    """

    def __init__(self, specs, seed: int = 0):
        self.specs = tuple(specs)
        self.seed = seed
        self._lock = threading.Lock()
        self._hits: dict[str, int] = {}
        self._fired: dict[str, int] = {}

    @classmethod
    def from_string(cls, s: str, seed: int = 0) -> "FaultPlan":
        specs = [FaultSpec.parse(p) for p in s.split(",") if p.strip()]
        return cls(specs, seed=seed)

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def fired(self, point: str) -> int:
        with self._lock:
            return self._fired.get(point, 0)

    def _on_hit(self, point: str) -> FaultSpec | None:
        with self._lock:
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            for spec in self.specs:
                if spec.point == point and spec.fires(hit):
                    self._fired[point] = self._fired.get(point, 0) + 1
                    return spec
        return None


_PLAN: FaultPlan | None = None
_ENV_LOADED = False


def active_plan() -> FaultPlan | None:
    """The armed plan, loading ``REPRO_FAULTS`` lazily on first use (so
    the env var set by a CI step or subprocess harness is honored without
    any import-order ceremony)."""
    global _PLAN, _ENV_LOADED
    if _PLAN is None and not _ENV_LOADED:
        _ENV_LOADED = True
        env = os.environ.get("REPRO_FAULTS", "")
        if env:
            _PLAN = FaultPlan.from_string(
                env, seed=int(os.environ.get("REPRO_FAULTS_SEED", "0")))
    return _PLAN


def fault_point(name: str, **ctx) -> None:
    """Declare a named injection site. Free when no plan is armed."""
    plan = _PLAN if _PLAN is not None else active_plan()
    if plan is None:
        return
    spec = plan._on_hit(name)
    if spec is None:
        return
    detail = f"injected {spec.mode} at {name!r} (hit {plan.hits(name)}" \
             + (f", {ctx}" if ctx else "") + ")"
    if spec.mode == "stall":
        time.sleep(spec.stall_s)
        return
    if spec.mode == "crash":
        raise InjectedCrash(detail)
    if spec.mode == "fatal":
        raise InjectedFatal(detail)
    raise InjectedFault(detail)


@contextlib.contextmanager
def inject(*specs: FaultSpec | str, seed: int = 0):
    """Arm a plan for the enclosed block (specs or spec strings) and hand
    it back for accounting asserts. Nested arming is rejected — two
    overlapping plans would make hit counts meaningless."""
    global _PLAN
    parsed = [FaultSpec.parse(s) if isinstance(s, str) else s for s in specs]
    plan = FaultPlan(parsed, seed=seed)
    assert _PLAN is None, "a fault plan is already armed"
    _PLAN = plan
    try:
        yield plan
    finally:
        _PLAN = None
