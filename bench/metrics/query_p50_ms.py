"""query_p50_ms (ms, host clock): the median (nearest rank), over every
query due in the window, of its due time to the return of the flush that
answered it; a query never answered counts as infinite."""
from bench.cell import percentile


def read(rec):
    q = rec.get("q")
    return None if q is None else percentile(rec["query_lat_ms"], 50)
