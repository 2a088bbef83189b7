"""hot_tier_share (%, program counter): queries of the window served
over the pinned hot tier (misses whose routed clusters were all pinned),
over the queries answered; from ``AsyncServer.cache_stats`` read at each
end of the window. Nothing where the deployment has no hot set."""
import numpy as np

from bench.cell import window_serving


def read(rec):
    q, s = rec.get("q"), rec.get("serving")
    if q is None or s is None or not rec["server"].get("hotset", False):
        return None
    n = int(np.isfinite(q["answered"]).sum())
    return 100.0 * window_serving(s)["cache"]["hot_served"] / n if n else None
