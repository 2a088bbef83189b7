"""torch_ops_ms.ingest (ms, device trace): device time a batch in
operations that are not the port's own kernels (the clustering fold's
one-hot product, the store's cumsum and scatter, the publish's clones,
copies and fills), in a cell without queries: all such device time in the
window over the batches the ingest thread applied in it."""

PORT = ("admit_prologue_kernel", "assign_tile_kernel", "heavy_hitter_kernel",
        "heavy_hitter_prep_kernel", "route_tile_kernel", "route_select_kernel",
        "route_merge_kernel", "serve_rerank_kernel", "mips_", "rerank_kernel",
        "prefilter_kernel", "unit_rows_rsqrt_kernel")


def read(rec):
    if rec.get("device_events") is None or rec.get("ingest") is None:
        return None
    t0, t1 = rec["window"]
    n = sum(1 for s in rec["program_spans"]
            if s[0] == "ingest.admit" and s[1] >= t0 and s[2] <= t1)
    if not n:
        return None
    dev = sum(min(b, t1) - max(a, t0) for name, a, b in rec["device_events"]
              if b > t0 and a < t1 and not any(p in name for p in PORT))
    return dev * 1e3 / n
