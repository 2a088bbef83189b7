"""The program's spans (``obs`` tracer, ``rec["program_spans"]``) for the
span readers."""
import numpy as np


def spans(rec, name):
    """(start, end, args) of the program's ``name`` spans that lie wholly
    inside the window."""
    t0, t1 = rec["window"]
    return [(a, b, args) for n, a, b, args, *_ in rec["program_spans"]
            if n == name and a >= t0 and b <= t1]


def median_ms(rec, name):
    """The median duration of the window's ``name`` spans, or None."""
    d = [b - a for a, b, _ in spans(rec, name)]
    return float(np.median(d)) * 1e3 if d else None
