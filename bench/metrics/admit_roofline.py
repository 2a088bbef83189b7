"""admit_roofline (%, device trace): the frozen bound of each ``admit``
call (bench/cost/admit.py, at its batch's rows) over the device time of
the kernel's two launches, summed over the window's ``ingest.admit``
spans."""
from bench.metrics._kernels import time_in_spans

NAMES = ("admit_prologue_kernel", "assign_tile_kernel")


def read(rec):
    from bench.cost import admit

    if rec.get("device_events") is None:
        return None
    t0, t1 = rec["window"]
    sp = [(a, b, args["batch"]) for n, a, b, args, _ in rec["program_spans"]
          if n == "ingest.admit" and a >= t0 and b <= t1]
    dev, hit = time_in_spans(rec["device_events"], NAMES,
                                [(a, b) for a, b, _ in sp])
    if not hit or dev <= 0:
        return None
    dep = rec["dep"]
    ms = sum(admit.bound(B, dep.dim, dep.k, dep.n_basis) for _, _, B in sp)
    return 100.0 * ms * 1e-3 / dev
