"""Serving launcher: ``python -m repro_torch.launch.serve [--stream nyt] [...]``.

Stands up a RAG server over a simulated stream and drives a Zipf query
workload against the live index, printing latency/recall stats. Runs on
the ``cuda`` card unless ``--device cpu`` says otherwise (no card: it
exits with an error, it never falls back).

``--mesh D,M`` (e.g. ``--mesh 2,2``) serves from the sharded engine
instead: the stream is data-sharded D ways for ingest and the document
store is cluster-sharded M ways for two-stage retrieval. The D*M shards
all share the one card (or the CPU); the device map is printed.

``--async`` serves through ``serve.runtime.AsyncServer``: a background
thread ingests the stream and publishes snapshots every
``--reconcile-every`` batches (delta publication when sharded), so
queries answer from the latest snapshot without waiting for ingest.
Shutdown drains the pending queue completely — the launcher asserts
``queries answered == queries submitted``.

``--cache-entries N`` / ``--hotset`` (with ``--two-stage --async``) arm
the two-level serving cache: a snapshot-versioned exact result cache
with precise delta invalidation, and a query-side heavy-hitter hot set
whose routed clusters pin into a compact fast tier (bounded by
``--pin-budget-mb``, charged against the state-memory envelope). Both
levels answer exactly as uncached serving does whenever they answer.

``--checkpoint-dir DIR`` (with ``--async``) arms crash-safe streaming:
every ingest batch is journaled (write-ahead, fsync'd) before it is
enqueued, and the engine state is checkpointed every
``--checkpoint-every`` applied batches (full once, dirty-cluster deltas
after). If DIR already holds a previous run's state the server RECOVERS
first — checkpoint restore + journal-tail replay, bit-identical to the
uncrashed run — and prints a recovery line. SIGTERM triggers a graceful
drain: stop ingesting, publish the tail, answer every pending query,
take a final blocking checkpoint, and truncate the journal behind it.

``--adaptive`` (with ``--two-stage``) arms query-adaptive serving: every
flush picks a (nprobe, rerank depth) QueryPlan from a fixed ladder,
degrading under queue pressure (past ``--max-queue-depth``) from depth
halvings (floored at ``--min-depth``) through nprobe halvings to
explicit shedding, and recovering hysteretically. Shed queries are still
answered — with sentinel results and ``shed``/``degraded`` markers.
"""
from __future__ import annotations

import argparse
import signal

import numpy as np


def _parse_mesh(spec: str) -> tuple[int, int]:
    parts = [int(p) for p in spec.split(",")]
    if len(parts) == 1:
        parts = [1, parts[0]]
    assert len(parts) == 2 and all(p >= 1 for p in parts), \
        "--mesh takes 'D,M' (data shards, model/store shards)"
    return parts[0], parts[1]


def _args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stream", default="nyt")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batches", type=int, default=50)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--qps", type=int, default=32, help="queries per batch")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--two-stage", action="store_true",
                    help="routed two-stage retrieval (needs a doc store)")
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--store-depth", type=int, default=8)
    ap.add_argument("--store-dtype", choices=("fp32", "int8"),
                    default="fp32",
                    help="ring-buffer embedding precision; int8 holds ~4x "
                         "the docs per store byte (fp32-accumulating "
                         "dequant rerank)")
    ap.add_argument("--mesh", default="",
                    help="'D,M' sharded engine: D data shards, M store "
                         "shards (default: single device)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--async", dest="async_serve", action="store_true",
                    help="background ingest thread + snapshot publication "
                         "(queries never block on ingest)")
    ap.add_argument("--adaptive", action="store_true",
                    help="query-adaptive serving (needs --two-stage): "
                         "under queue pressure each flush degrades along "
                         "the plan ladder (depth -> nprobe -> shed) and "
                         "recovers hysteretically; answers carry explicit "
                         "degraded/shed markers")
    ap.add_argument("--cache-entries", type=int, default=0,
                    help="snapshot-versioned exact result cache capacity "
                         "(needs --two-stage --async; 0 disables). Delta "
                         "publications invalidate precisely: only entries "
                         "routed through dirty clusters are evicted")
    ap.add_argument("--hotset", action="store_true",
                    help="query-side heavy-hitter hot set (needs "
                         "--two-stage --async): hot route sets' clusters "
                         "pin into a compact fast tier served through the "
                         "serve kernel, with the full store's answers")
    ap.add_argument("--pin-budget-mb", type=float, default=8.0,
                    help="hot-tier pin budget in MiB (pow2-floored to a "
                         "fixed cluster bucket, charged against "
                         "state_memory_bytes)")
    ap.add_argument("--max-queue-depth", type=int, default=256,
                    help="pending-query high watermark that escalates "
                         "the degradation ladder one level per flush")
    ap.add_argument("--min-depth", type=int, default=1,
                    help="floor of the plan ladder's rerank-depth "
                         "halvings (degradation never reranks shallower)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="arm crash-safe streaming (needs --async): "
                         "write-ahead journal + full/delta engine "
                         "checkpoints under this directory; a non-empty "
                         "directory is RECOVERED from first")
    ap.add_argument("--journal-dir", default="",
                    help="journal location override (default: "
                         "<checkpoint-dir>/journal — e.g. a faster disk)")
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    help="applied ingest batches between checkpoints; "
                         "shorter cadence = shorter journal tail to "
                         "replay on recovery, more checkpoint writes")
    ap.add_argument("--reconcile-every", type=int, default=4,
                    help="ingest batches between snapshot publications "
                         "(sharded reconcile / async publish cadence)")
    ap.add_argument("--metrics-json", default="",
                    help="enable telemetry and dump the metrics registry "
                         "as JSON to this path on exit")
    ap.add_argument("--trace-out", default="",
                    help="enable span tracing and export a Chrome "
                         "trace-event JSON (Perfetto-loadable) on exit")
    ap.add_argument("--report-every", type=int, default=10,
                    help="serving-report line every N stream batches")
    return ap.parse_args(argv)


def main(argv=None):
    args = _args(argv)
    mesh_shape = _parse_mesh(args.mesh) if args.mesh else None

    from repro_torch import obs
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.data.streams import make_stream
    from repro_torch.kernels.common import resolve_device
    from repro_torch.obs.report import Reporter
    from repro_torch.serve.durability import DurabilityConfig
    from repro_torch.serve.runtime import AsyncServer, ServerConfig
    from repro_torch.serve.server import RAGServer

    device = resolve_device(args.device)
    if args.metrics_json or args.trace_out:
        obs.enable(metrics=bool(args.metrics_json),
                   trace=bool(args.trace_out))

    stream = make_stream(args.stream, dim=args.dim)
    warm = np.concatenate(
        [stream.next_batch(args.batch)["embedding"] for _ in range(2)])
    k = 150
    if mesh_shape is not None:  # cluster sharding needs k % M == 0
        m = mesh_shape[1]
        k = -(-k // m) * m
    cfg = paper_pipeline_config(
        dim=args.dim, k=k, capacity=100, update_interval=256, alpha=0.1,
        store_depth=args.store_depth if args.two_stage else 0,
        store_dtype=args.store_dtype)
    assert not args.adaptive or args.two_stage, \
        "--adaptive requires --two-stage (plans schedule rerank effort)"
    assert not (args.cache_entries or args.hotset) or args.two_stage, \
        "--cache-entries/--hotset require --two-stage (cached answers " \
        "record routed clusters)"
    assert not (args.cache_entries or args.hotset) or args.async_serve, \
        "--cache-entries/--hotset require --async (the cache is exact " \
        "only over published snapshots)"
    assert args.cache_entries >= 0, "--cache-entries must be >= 0"
    assert args.pin_budget_mb > 0, "--pin-budget-mb must be positive"
    assert not (args.checkpoint_dir or args.journal_dir) \
        or args.async_serve, \
        "--checkpoint-dir/--journal-dir require --async (durability " \
        "journals the background ingest path)"
    assert not args.journal_dir or args.checkpoint_dir, \
        "--journal-dir is an override of --checkpoint-dir's default"
    assert args.checkpoint_every >= 1, "--checkpoint-every must be >= 1"
    durability = None
    if args.checkpoint_dir:
        durability = DurabilityConfig(
            checkpoint_dir=args.checkpoint_dir,
            journal_dir=args.journal_dir or None,
            checkpoint_every=args.checkpoint_every)
    scfg = ServerConfig(max_batch=args.qps, topk=args.topk,
                        two_stage=args.two_stage, nprobe=args.nprobe,
                        adaptive=args.adaptive,
                        max_queue_depth=args.max_queue_depth,
                        min_depth=args.min_depth,
                        cache_entries=args.cache_entries,
                        hotset=args.hotset,
                        pin_budget_mb=args.pin_budget_mb)

    engine = None
    if mesh_shape is not None:
        from repro_torch.engine.sharded import ShardedEngine
        from repro_torch.launch.mesh import make_streaming_mesh

        mesh = make_streaming_mesh(*mesh_shape, devices=device)
        engine = ShardedEngine(
            cfg, mesh, 0, warmup=warm,
            # async: the runtime's publish cadence drives (delta) reconcile
            reconcile_every=10**9 if args.async_serve
            else args.reconcile_every,
            reconcile_mode="delta" if args.async_serve else "full")
        print(f"device map       : {engine.describe()}")
    if args.async_serve:
        server = AsyncServer(cfg, scfg, 0, warmup=warm, engine=engine,
                             publish_every=args.reconcile_every,
                             durability=durability, device=device)
        rep = server.recovery_report
        if rep is not None:
            print(f"recovered        : checkpoint_seq={rep['checkpoint_seq']} "
                  f"replayed={rep['replayed']} batches "
                  f"({rep['docs_replayed']} docs) "
                  f"quarantined={rep['quarantined']}")
    else:
        server = RAGServer(cfg, scfg, 0, warmup=warm, engine=engine,
                           device=device)

    # SIGTERM = graceful drain: finish the current round, skip the rest
    # of the stream, then fall through to the normal shutdown path
    # (final publish, full queue drain, blocking checkpoint + journal
    # truncation in close()) — answered == submitted still holds.
    terminated = []
    signal.signal(signal.SIGTERM, lambda *_: terminated.append(True))

    reporter = Reporter(server, every=args.report_every)
    submitted = 0
    answered = 0
    for i in range(args.batches):
        if terminated:
            print(f"sigterm          : draining after {i}/{args.batches} "
                  f"batches")
            break
        b = stream.next_batch(args.batch)
        qs = stream.queries(args.qps)
        for q in qs["embedding"]:
            server.submit(q)
            submitted += 1
        outs = server.serve_round(b)
        answered += len(outs)
        reporter.round_done(i)

    # Shutdown: drain the WHOLE pending queue (one flush answers at most
    # max_batch and would silently drop the rest).
    if args.async_serve:
        server.sync()            # final publish covers the stream tail
    answered += len(server.drain())
    reporter.final(submitted, answered)
    assert answered == submitted, "shutdown drain lost queries"
    if args.async_serve:
        server.close()   # durable: final blocking checkpoint + truncation
    print(f"index size       : {server.engine.index_size()} prototypes")
    if durability is not None:
        rs = server.robustness_stats()
        print(f"durability       : checkpoint_seq={rs['checkpoint_seq']} "
              f"saves={rs['checkpoint_saves']} "
              f"journal_tail={rs['journal_lag_batches']} batches "
              f"({rs['journal_disk_bytes']} B, "
              f"{rs['journal_segments']} segments)")
        print(f"supervision      : restarts={rs['restarts']} "
              f"quarantined={rs['quarantined']}")
    if args.cache_entries or args.hotset:
        cs = server.cache_stats()
        print(f"serving cache    : hit_rate={cs['hit_rate']:.3f} "
              f"hits={cs['hits']} invalidated={cs['invalidated']} "
              f"rekeyed={cs['rekeyed']}")
        print(f"hot tier         : pinned={cs['pinned_clusters']} clusters "
              f"({cs['pinned_bytes']} B) hot_served={cs['hot_served']} "
              f"rebuilds={cs['tier_rebuilds']}")
        print(f"state memory     : {server.state_memory_bytes()} B "
              f"(incl. pinned tier)")
    if args.adaptive:
        print(f"plan ladder      : {' -> '.join(server.plan_space.describe())}")
        print(f"queries shed     : {server.stats['shed']}")
    if mesh_shape is not None:
        print(f"store bytes/dev  : {server.engine.store_bytes_per_device()}")
    reg, tr = obs.metrics(), obs.tracer()
    if args.metrics_json and reg is not None:
        reg.dump_json(args.metrics_json)
        print(f"metrics json     : {args.metrics_json}")
    if args.trace_out and tr is not None:
        tr.export(args.trace_out)
        print(f"chrome trace     : {args.trace_out} ({len(tr)} events)")


if __name__ == "__main__":
    main()
