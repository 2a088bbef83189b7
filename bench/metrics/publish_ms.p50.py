"""publish_ms.p50 (ms, program span): the median duration of the
program's ``ingest.publish`` spans inside the window (the snapshot's
clone and the swap)."""
import numpy as np


def read(rec):
    t0, t1 = rec["window"]
    d = [b - a for n, a, b, *_ in rec["program_spans"]
         if n == "ingest.publish" and a >= t0 and b <= t1]
    return float(np.median(d)) * 1e3 if d else None
