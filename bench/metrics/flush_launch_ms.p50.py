"""flush_launch_ms.p50 (ms, program span): the median duration of the
program's ``flush.launch`` spans inside the window: the part of a flush
that queues its device work (the snapshot pinned, the queries to the
card, the serve call and the decode)."""
from bench.metrics._spans import median_ms


def read(rec):
    return median_ms(rec, "flush.launch")
