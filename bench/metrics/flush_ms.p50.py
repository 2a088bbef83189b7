"""flush_ms.p50 (ms, program span): the median duration of the program's
``flush`` spans (``obs`` tracer) inside the window."""
import numpy as np


def read(rec):
    t0, t1 = rec["window"]
    d = [b - a for n, a, b, *_ in rec["program_spans"]
         if n == "flush" and a >= t0 and b <= t1]
    return float(np.median(d)) * 1e3 if d else None
