"""Launch and plain-call counts of the port's kernels.

A run shows that its main path went through the kernels by resetting
these just before it and reading them just after: each kernel's wrapper
adds one to ``kernel`` where it launches, each plain version adds one to
``plain`` when it runs.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CallCounts:
    """Launches of one hand-written kernel (``kernel``, counted by its
    wrapper where it launches) and calls of its plain version (``plain``,
    counted by the plain function itself)."""

    kernel: int = 0
    plain: int = 0

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


COUNTS: dict[str, CallCounts] = {
    "admit": CallCounts(),
    "serve": CallCounts(),
    "serve_route": CallCounts(),   # serve.cu's route-only entry
    "mips": CallCounts(),
    "rerank": CallCounts(),
    "prefilter": CallCounts(),
    "assign": CallCounts(),
    "bag": CallCounts(),
    "bag_backward": CallCounts(),   # bag's gradient (port-side: no pallas_call)
    "gather_backward": CallCounts(),   # bag_backward.cu's gather transpose
    "segment_sum": CallCounts(),   # the same entry as a segment sum (the GNN's aggregation)
    "heavy_hitter": CallCounts(),
}


def reset_all() -> None:
    for c in COUNTS.values():
        c.reset()


def snapshot() -> dict[str, dict[str, int]]:
    return {name: {"kernel": c.kernel, "plain": c.plain}
            for name, c in COUNTS.items()}
