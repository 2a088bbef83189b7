"""Kernel time inside host spans, for the roofline readers."""
import bisect


def time_in_spans(events, names, spans):
    """Device seconds of events whose name contains one of ``names`` and
    that start inside one of the (start, end) ``spans``, and the number
    of spans that hold at least one."""
    evs = sorted((a, b) for n, a, b in events if any(k in n for k in names))
    starts = [a for a, _ in evs]
    total, hit = 0.0, 0
    for s0, s1 in spans:
        i = bisect.bisect_left(starts, s0)
        j = bisect.bisect_right(starts, s1)
        if j > i:
            hit += 1
            total += sum(b - a for a, b in evs[i:j])
    return total, hit
