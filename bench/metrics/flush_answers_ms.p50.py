"""flush_answers_ms.p50 (ms, program span): the median duration of the
program's ``flush.answers`` spans inside the window: a flush's answer
dicts, its stats and its registry update, after the device->host
copies."""
from bench.metrics._spans import median_ms


def read(rec):
    return median_ms(rec, "flush.answers")
