"""queue_wait_ms.p95 (ms, host clock): the 95th percentile of a query's
due time to the start of the benchmark's span around the flush call
that answered it."""
import numpy as np

from bench.cell import percentile


def read(rec):
    q = rec.get("q")
    if q is None:
        return None
    wait = (q["flush_start"] - q["due"]) * 1e3
    wait = wait[np.isfinite(wait)]
    return percentile(wait, 95) if wait.size else None
