"""frontend_wait_ms.p95 (ms, program span): the 95th percentile (nearest
rank) of the ``wait_us`` of the program's ``query`` spans inside the
window: each query's submit to the start of the flush that answered it,
the front end's own queue wait (``queue_wait_ms.p95`` is the host-clock
counterpart, from the due time). None where no span carries it."""
import numpy as np

from bench.cell import percentile
from bench.metrics._spans import spans


def read(rec):
    w = [args["wait_us"] for _, _, args in spans(rec, "query")
         if "wait_us" in args]
    return percentile(np.asarray(w), 95) * 1e-3 if w else None
