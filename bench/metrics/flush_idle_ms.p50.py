"""flush_idle_ms.p50 (ms, device trace): the median, over the program's
``flush`` spans inside the window, of the span's length less its overlap
with the device-busy intervals (``rec["busy"]``): host time inside a
flush during which no operation ran on any stream. None without a device
trace."""
import bisect

import numpy as np

from bench.metrics._spans import spans


def idle(a, b, busy, starts):
    """The length of [a, b] less its overlap with ``busy``, sorted
    disjoint (start, end) intervals whose starts are ``starts``."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    over = 0.0
    while i < len(busy) and busy[i][0] < b:
        over += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return (b - a) - over


def read(rec):
    busy = rec.get("busy")
    if busy is None:
        return None
    starts = [s for s, _ in busy]
    d = [idle(a, b, busy, starts) for a, b, _ in spans(rec, "flush")]
    return float(np.median(d)) * 1e3 if d else None
