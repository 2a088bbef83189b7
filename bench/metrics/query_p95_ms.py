"""query_p95_ms (ms, host clock): the 95th percentile (nearest rank), over
every query due in the window, of its due time to the return of the
flush that answered it; a query never answered counts as infinite. A
per-layer metric: read in the traced run, where the window runs with the
program's tracer on and the collector off."""
from bench.cell import percentile


def read(rec):
    q = rec.get("q")
    return None if q is None else percentile(rec["query_lat_ms"], 95)
