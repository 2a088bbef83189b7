"""idle_share (%, device trace): the share of the window in which no
operation ran on the device (1 - the union of device-busy intervals over
the window). It reads every cell alike; ``BENCHMARK.json`` names it once
for each end-to-end metric it moves (``idle_share.query``,
``idle_share.ingest``), and each name finds this file by its stem."""


def read(rec):
    if rec.get("busy") is None:
        return None
    t0, t1 = rec["window"]
    return 100.0 * (1.0 - sum(b - a for a, b in rec["busy"]) / (t1 - t0))
