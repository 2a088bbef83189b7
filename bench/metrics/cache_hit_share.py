"""cache_hit_share (%, program counter): queries of the window the
result cache answered (route-free and route-checked hits), over the
queries answered; from ``AsyncServer.cache_stats`` read at each end of
the window. Nothing where the deployment has no result cache."""
import numpy as np

from bench.cell import window_serving


def read(rec):
    q, s = rec.get("q"), rec.get("serving")
    if q is None or s is None or rec["server"].get("cache_entries", 0) <= 0:
        return None
    n = int(np.isfinite(q["answered"]).sum())
    return 100.0 * window_serving(s)["cache"]["hits"] / n if n else None
