"""Runtime query plans: per-flush retrieval effort as a value.

A :class:`QueryPlan` is what the serving layer chooses per flush: how
many clusters the prototype index routes (``nprobe``), how deep into each
routed ring the rerank reads (``depth``), and whether the flush is shed
outright (``shed`` — answered with an explicit marker, never touching
the engine). :class:`PlanSpace` is the fixed ladder of effort buckets
(full effort first, then depth halvings, then nprobe halvings, then
shed), every bucket honoring ``k <= nprobe * depth``; ``bucket()``
rounds any requested plan *up* onto the ladder. The ladder order is the
degradation policy. Full effort (``PlanSpace.full``) is the plan-free
query: ``depth == store_depth`` takes the no-slice path.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One flush's retrieval effort: route ``nprobe`` clusters, rerank
    the first ``depth`` ring slots of each (an age-uniform subset once
    the ring wraps), or ``shed`` the flush."""

    nprobe: int
    depth: int
    shed: bool = False

    @property
    def key(self) -> str:
        """Bucket tag (``np{n}xd{d}``) — the tune-cache / trace-counter
        variant key for this plan's compiled serve program."""
        return f"np{self.nprobe}xd{self.depth}"


class PlanSpace:
    """The fixed, ordered degradation ladder of effort buckets.

    ``ladder[0]`` is full effort; each subsequent level halves depth
    until ``min_depth`` (or the ``k`` constraint) stops it, then halves
    nprobe until ``min_nprobe``, and the final level sheds. Every
    non-shed level satisfies ``k <= nprobe * depth`` by construction, so
    any ladder plan is a valid engine call.
    """

    def __init__(self, *, nprobe: int, depth: int, k: int,
                 min_depth: int = 1, min_nprobe: int = 1):
        assert depth > 0 and nprobe > 0 and k > 0
        assert k <= nprobe * depth, "k must be <= nprobe * depth"
        self.k = k
        ladder = [QueryPlan(nprobe, depth)]
        d = depth
        while d // 2 >= min_depth and nprobe * (d // 2) >= k:
            d //= 2
            ladder.append(QueryPlan(nprobe, d))
        p = nprobe
        while p // 2 >= min_nprobe and (p // 2) * d >= k:
            p //= 2
            ladder.append(QueryPlan(p, d))
        ladder.append(QueryPlan(p, d, shed=True))
        self.ladder: tuple[QueryPlan, ...] = tuple(ladder)

    @property
    def full(self) -> QueryPlan:
        return self.ladder[0]

    @property
    def buckets(self) -> tuple[QueryPlan, ...]:
        """The compiled-variant set: every non-shed ladder level."""
        return tuple(pl for pl in self.ladder if not pl.shed)

    def bucket(self, plan: QueryPlan) -> QueryPlan:
        """Round an arbitrary requested plan *up* onto the ladder.

        Returns the lowest-effort ladder level that still dominates the
        request in both dimensions (nprobe and depth) — effort is never
        silently reduced, and requests above full effort clamp to full.
        Shed requests map to the shed level.
        """
        if plan.shed:
            return self.ladder[-1]
        out = self.full
        for pl in self.buckets:
            if pl.nprobe >= plan.nprobe and pl.depth >= plan.depth:
                out = pl
        return out

    def level(self, plan: QueryPlan) -> int:
        """Degradation level of a ladder plan (0 = full effort)."""
        return self.ladder.index(plan)

    def describe(self) -> list[str]:
        return [("shed" if pl.shed else pl.key) for pl in self.ladder]
