"""ingest_docs_per_s (docs/s, host clock): the live documents whose batch
the server's ingest thread applied between the window's two ends, over
the seconds between those two readings."""


def read(rec):
    ing = rec.get("ingest")
    return None if ing is None else ing["docs"] / ing["window_s"]
