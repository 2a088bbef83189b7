"""gen_late_ms.p99 (ms, host clock): how late the load generator handed
queries to the front end: the 99th percentile of submit time minus due
time over the window's queries."""
import numpy as np

from bench.cell import percentile


def read(rec):
    q = rec.get("q")
    if q is None or not q["due"].size:
        return None
    late = (q["submitted"] - q["due"]) * 1e3
    return percentile(late[np.isfinite(late)], 99)
