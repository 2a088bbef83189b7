"""ingest_batch_ms.p50 (ms, program span): the median duration of the
program's ``ingest.admit`` spans inside the window: the ingest thread's
host time for one batch, its one device sync included."""
import numpy as np


def read(rec):
    t0, t1 = rec["window"]
    d = [b - a for n, a, b, *_ in rec["program_spans"]
         if n == "ingest.admit" and a >= t0 and b <= t1]
    return float(np.median(d)) * 1e3 if d else None
