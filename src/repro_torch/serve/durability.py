"""Crash-safe streaming: write-ahead ingest journal + incremental engine
checkpoints + deterministic recovery (the reference's
``serve/durability.py``).

The async runtime's state is the stream — a crashed ingest thread or
process must not lose admitted documents. This module makes the ingest
side restartable with a BIT-IDENTICAL contract: recovered engine state
(and therefore every subsequent query answer) is leaf-for-leaf equal to
the engine that never crashed.

Three pieces:

``IngestJournal`` — a bounded write-ahead log. Every stream batch is
appended (monotone sequence numbers, CRC-protected records, fsync'd
segments) BEFORE it is enqueued for ingest, so a batch the producer saw
accepted can always be replayed. Segments roll at ``segment_bytes`` and
are truncated once a durable checkpoint covers them; a torn tail record
(crash mid-append) is detected by length/CRC and dropped. The record
format (``RJL1``, header ``<4sqIIII``, CRC32 of ids then embeddings) is
the reference's byte for byte: a journal written by either package
replays in the other.

``CheckpointStore`` — atomic engine checkpoints following
``train.checkpoint`` conventions (tmp dir + ``os.replace``, npz + JSON
meta, background writer thread). The first checkpoint is FULL;
subsequent ones are DELTA: the per-cluster leaves (centroids / counts /
reps / the whole doc store) only write the rows of clusters whose
(counts, ring ptr, rep id) signature changed since the last durable
checkpoint, while the small non-per-cluster leaves (prefilter, counter,
index, host counters, the generator's state) ride along in full. On a
card the rows are gathered and copied to pinned host memory on the
caller's stream (the ingest stream) with no device sync; the writer
thread waits on one event and does only disk I/O, so a query flush never
waits for a checkpoint. A failed write never advances the signature
baseline. The directory layout is the reference's; the two packages'
checkpoints do not cross-read (the random-number leaves differ).

``replay_journal`` / ``DurableIngest`` — recovery = restore the latest
checkpoint chain (full + ordered deltas), then re-ingest the journal
tail through the NORMAL ingest path. Determinism of the engine's ingest
makes the result bit-identical to the uncrashed run. Poison batches
(batches that keep raising on replay) are quarantined after a bounded
retry budget — logged and counted, never silently dropped.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import struct
import threading
import time
import zlib
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch import obs
from repro_torch.testing import faults
from repro_torch.train import checkpoint as ckpt_lib

# ---------------------------------------------------------------------------
# error classification

_TRANSIENT_TYPES = (TimeoutError, ConnectionError, BrokenPipeError)


def classify_error(e: BaseException) -> str:
    """``"transient"`` (supervisor retries within its bounded budget) or
    ``"fatal"`` (surface to the caller). An exception opts into either
    class with a truthy/falsy ``transient`` attribute (the fault
    harness's ``InjectedFault``/``InjectedFatal`` do); otherwise only a
    small allowlist of environmental errors is retried — everything
    else (shape errors, assertion failures, ...) is a bug and must not
    be masked by retry."""
    marked = getattr(e, "transient", None)
    if marked is not None:
        return "transient" if marked else "fatal"
    return "transient" if isinstance(e, _TRANSIENT_TYPES) else "fatal"


# ---------------------------------------------------------------------------
# write-ahead ingest journal

_MAGIC = b"RJL1"
# magic, seq, batch, dim, emb dtype code, payload crc32
_HEADER = struct.Struct("<4sqIIII")
_DTYPES = {0: np.float32, 1: np.float16, 2: np.int8}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class IngestJournal:
    """Append-only segmented WAL of (seq, embeddings, doc_ids) batches.

    Thread-safe; appends fsync when ``fsync=True`` (the durability
    default — a record returned from ``append`` survives the process).
    ``truncate(seq)`` drops whole segments entirely covered by a durable
    checkpoint; the active segment is never deleted in place.
    """

    def __init__(self, directory: str, *, segment_bytes: int = 8 << 20,
                 fsync: bool = True):
        self.dir = directory
        self.segment_bytes = max(1, segment_bytes)
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._fh: io.BufferedWriter | None = None
        self._fh_bytes = 0
        self.bytes_appended = 0
        self.appends = 0
        self.truncated_segments = 0
        self._last_seq = self._scan_last_seq()

    # ------------------------------------------------------------- segments
    def _segments(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("seg_") and name.endswith(".wal"):
                out.append((int(name[4:-4]), os.path.join(self.dir, name)))
        return sorted(out)

    def _scan_last_seq(self) -> int:
        segs = self._segments()
        if not segs:
            return -1
        last = -1
        for seq, _x, _i in self._iter_segment(segs[-1][1]):
            last = seq
        # the last segment can be empty only via a torn first record;
        # its name still carries the first seq it was rolled for
        return last if last >= 0 else segs[-1][0] - 1

    def _open_segment(self, first_seq: int) -> None:
        path = os.path.join(self.dir, f"seg_{first_seq:012d}.wal")
        self._fh = open(path, "ab")
        self._fh_bytes = self._fh.tell()
        if self.fsync:
            ckpt_lib.fsync_dir(self.dir)

    # --------------------------------------------------------------- append
    def append(self, seq: int, x: np.ndarray, ids: np.ndarray) -> int:
        """Write one batch record and make it durable. Returns the bytes
        appended. ``seq`` must be the next monotone sequence number."""
        x = np.ascontiguousarray(x)
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        assert x.ndim == 2 and ids.shape == (x.shape[0],), \
            (x.shape, ids.shape)
        code = _DTYPE_CODES.get(x.dtype)
        assert code is not None, f"unjournalable embedding dtype {x.dtype}"
        payload = ids.tobytes() + x.tobytes()
        header = _HEADER.pack(_MAGIC, seq, x.shape[0], x.shape[1], code,
                              zlib.crc32(payload))
        with self._lock:
            assert seq == self._last_seq + 1, \
                f"journal seq must be monotone: got {seq}, " \
                f"expected {self._last_seq + 1}"
            if self._fh is None or self._fh_bytes >= self.segment_bytes:
                if self._fh is not None:
                    self._fh.close()
                self._open_segment(seq)
            self._fh.write(header)
            self._fh.write(payload)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            n = len(header) + len(payload)
            self._fh_bytes += n
            self.bytes_appended += n
            self.appends += 1
            self._last_seq = seq
            return n

    def last_seq(self) -> int:
        """Highest durable sequence number (-1 for an empty journal)."""
        with self._lock:
            return self._last_seq

    # --------------------------------------------------------------- replay
    @staticmethod
    def _iter_segment(path: str):
        with open(path, "rb") as f:
            while True:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    return  # clean EOF or torn header: stop here
                magic, seq, b, d, code, crc = _HEADER.unpack(head)
                if magic != _MAGIC or code not in _DTYPES:
                    return  # corrupt tail
                dt = np.dtype(_DTYPES[code])
                n = b * 4 + b * d * dt.itemsize
                payload = f.read(n)
                if len(payload) < n or zlib.crc32(payload) != crc:
                    return  # torn/corrupt record: drop the tail
                ids = np.frombuffer(payload, np.int32, count=b)
                x = np.frombuffer(payload, dt, offset=b * 4).reshape(b, d)
                yield seq, x, ids

    def replay(self, start_seq: int = 0) -> Iterator[tuple[int, np.ndarray,
                                                           np.ndarray]]:
        """Yield (seq, x, ids) for every durable record with
        ``seq >= start_seq``, in order. Safe against a torn tail."""
        with self._lock:
            segs = self._segments()
        expect = None  # first surviving record anchors the contiguity check
        for _first, path in segs:
            for seq, x, ids in self._iter_segment(path):
                assert expect is None or seq == expect, \
                    f"journal gap: got seq {seq}, expected {expect}"
                expect = seq + 1
                if seq >= start_seq:
                    yield seq, x, ids

    # ------------------------------------------------------------- truncate
    def truncate(self, up_to_seq: int) -> int:
        """Delete segments whose every record has ``seq <= up_to_seq``
        (they are covered by a durable checkpoint). Returns the number of
        segments removed. The active segment always survives."""
        removed = 0
        with self._lock:
            segs = self._segments()
            for i in range(len(segs) - 1):  # never the active/last one
                next_first = segs[i + 1][0]
                if next_first <= up_to_seq + 1:
                    os.remove(segs[i][1])
                    removed += 1
                else:
                    break
            if removed:
                self.truncated_segments += removed
                if self.fsync:
                    ckpt_lib.fsync_dir(self.dir)
        return removed

    def stats(self) -> dict:
        with self._lock:
            segs = self._segments()
            disk = sum(os.path.getsize(p) for _s, p in segs
                       if os.path.exists(p))
            return {"last_seq": self._last_seq, "segments": len(segs),
                    "disk_bytes": disk, "appended_bytes": self.bytes_appended,
                    "appends": self.appends,
                    "truncated_segments": self.truncated_segments}

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------------------
# incremental engine checkpoints

# PipelineState leaves indexed by cluster on their (engine-relative)
# leading axis — the delta-checkpoint row set. Everything else is written
# in full every time (prefilter/counter/index/scalars/generator are small
# next to the ring store).
PER_CLUSTER_PATHS = (".clus.centroids", ".clus.counts", ".rep_ids",
                     ".rep_sims", ".store.embs", ".store.ids",
                     ".store.stamps", ".store.ptr", ".store.scales")
# the exact per-cluster change detector (same contract as the delta
# publication signature: every snapshot-visible cluster mutation implies
# a change in one of these)
_SIG_PATHS = (".clus.counts", ".store.ptr", ".rep_ids")


def _put_rows(arr: np.ndarray, idx: np.ndarray, rows: np.ndarray,
              axis: int) -> None:
    if axis == 0:
        arr[idx] = rows
    else:
        sl = [slice(None)] * arr.ndim
        sl[axis] = idx
        arr[tuple(sl)] = rows


class _HostCopy:
    """Host copies of the leaves one save writes, queued where they live.

    A leaf on a card is copied into pinned host memory by a non-blocking
    copy on the caller's current stream (the ingest stream), and one
    event is recorded after the last copy: the caller never synchronizes
    the device, and the writer thread waits on that event alone before it
    reads the buffers. The pinned buffers come from ``pool`` (one a leaf
    path, grown when a leaf outgrows it): a save starts only after the
    previous write finished, so they are free to reuse, and only a save
    that needs more room pays for pinning it. A host leaf is copied at
    once. ``copy_ms`` is the copies' device time (0 on the host)."""

    def __init__(self, leaves: dict, pool: dict[str, torch.Tensor]):
        self.arrays: dict[str, Any] = {}
        self._events = None
        on_card = {p: a for p, a in leaves.items()
                   if torch.is_tensor(a) and a.device.type == "cuda"}
        for path, leaf in on_card.items():   # pin before the timed copies
            n = leaf.numel() * leaf.element_size()
            if path not in pool or pool[path].numel() < n:
                pool[path] = torch.empty((n,), dtype=torch.uint8,
                                         pin_memory=True)
            self.arrays[path] = pool[path][:n].view(leaf.dtype).view(leaf.shape)
        if on_card:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
            for path, leaf in on_card.items():
                self.arrays[path].copy_(leaf, non_blocking=True)
            self._events[1].record()
        for path, leaf in leaves.items():
            if path not in on_card:
                self.arrays[path] = ckpt_lib.to_host(leaf)

    def numpy(self) -> tuple[dict[str, np.ndarray], float]:
        """(the host arrays, the copies' device ms), once they landed."""
        ms = 0.0
        if self._events is not None:
            self._events[1].synchronize()
            ms = self._events[0].elapsed_time(self._events[1])
        return ({p: a.numpy() if torch.is_tensor(a) else a
                 for p, a in self.arrays.items()}, ms)


def _nbytes(leaf) -> int:
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


class CheckpointStore:
    """Atomic full + delta checkpoints of an engine state tree.

    ``save(seq, tree)`` reads the per-cluster signature to the host,
    decides full-vs-delta from its diff, gathers the dirty rows where the
    state lives and queues their copies to host (``_HostCopy``: on a card
    a non-blocking copy on the calling thread's current stream, no device
    sync), then hands the file write to a background thread
    (``train.checkpoint`` convention) — ``on_durable(seq)`` fires after
    the atomic rename lands, which is where the runtime truncates the
    journal. A write failure is captured (``poll_error``), leaves the
    signature baseline untouched, and never corrupts prior checkpoints.

    ``cluster_axis`` is the axis per-cluster leaves index clusters on: 0
    for a single-device ``PipelineState``.
    """

    def __init__(self, directory: str, *, cluster_axis: int = 0,
                 keep_full: int = 2, full_every: int = 0,
                 delta_max_frac: float = 0.5, fsync: bool = True,
                 on_durable: Callable[[int], None] | None = None):
        self.dir = directory
        self.cluster_axis = cluster_axis
        self.keep_full = max(1, keep_full)
        self.full_every = full_every  # 0 = full only when forced/baseline
        self.delta_max_frac = delta_max_frac
        self.fsync = fsync
        self.on_durable = on_durable
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._sig: dict[str, np.ndarray] | None = None
        self._last_seq: int | None = None
        self._saves_since_full = 0
        self.saves = {"full": 0, "delta": 0, "failed": 0}
        self.bytes_written = {"full": 0, "delta": 0}
        self.last_save: dict | None = None
        self._pinned: dict[str, torch.Tensor] = {}   # _HostCopy's buffers

    # ----------------------------------------------------------------- save
    def _dirty_clusters(self, sig: dict[str, np.ndarray]) -> np.ndarray:
        k = sig[".clus.counts"].shape[self.cluster_axis]
        dirty = np.zeros((k,), bool)
        for path in _SIG_PATHS:
            new, old = sig[path], self._sig[path]
            if self.cluster_axis == 0:
                dirty |= new != old
            else:
                dirty |= np.any(new != old, axis=0)
        return np.nonzero(dirty)[0].astype(np.int32)

    def save(self, seq: int, tree, *, metadata: dict | None = None,
             force_full: bool = False, blocking: bool = False) -> dict:
        """Checkpoint ``tree`` as covering the journal through ``seq``.
        Returns {"mode", "dirty_clusters", "bytes"} for the save that was
        *scheduled* (bytes are exact: computed from the arrays written)."""
        self.wait()  # serialize writes (one in flight at a time)
        if (self._last_seq is not None and seq <= self._last_seq
                and not force_full):
            # nothing applied since the last durable checkpoint: writing
            # again would overwrite that step dir and break the delta
            # chain's prev pointers — a covered seq is a no-op
            return {"mode": "noop", "bytes": 0, "dirty_clusters": 0}
        flat = ckpt_lib.flatten_tree(tree)
        sig = {p: ckpt_lib.to_host(flat[p]) for p in _SIG_PATHS}
        k = sig[".clus.counts"].shape[self.cluster_axis]

        dirty = None
        if (not force_full and self._sig is not None
                and (self.full_every <= 0
                     or self._saves_since_full < self.full_every - 1)):
            idx = self._dirty_clusters(sig)
            if idx.size <= self.delta_max_frac * k:
                dirty = idx
        mode = "delta" if dirty is not None else "full"
        if mode == "delta":
            leaves = {}
            for p, a in flat.items():
                if p in PER_CLUSTER_PATHS:
                    idx_t = torch.from_numpy(dirty.astype(np.int64)).to(a.device)
                    a = a.index_select(self.cluster_axis, idx_t)
                leaves[p] = a
        else:
            leaves = flat
        nbytes = sum(_nbytes(a) for a in leaves.values())
        host = _HostCopy(leaves, self._pinned)
        meta = dict(metadata or {})
        meta.update({"seq": int(seq), "mode": mode,
                     "prev_seq": self._last_seq,
                     "cluster_axis": self.cluster_axis,
                     "dirty": ([] if dirty is None
                               else [int(c) for c in dirty]),
                     "num_clusters": int(k)})
        out = {"mode": mode, "bytes": nbytes,
               "dirty_clusters": (int(k) if dirty is None
                                  else int(dirty.size))}

        def write():
            arrays, copy_ms = host.numpy()
            t0 = time.perf_counter()
            faults.fault_point("checkpoint.write", seq=seq, mode=mode)
            tmp = os.path.join(self.dir, f"tmp.{seq}")
            final = os.path.join(self.dir, f"step_{seq:012d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{p.replace("/", "╱"): a for p, a in arrays.items()})
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if self.fsync:
                ckpt_lib.fsync_path(os.path.join(tmp, "arrays.npz"))
                ckpt_lib.fsync_path(os.path.join(tmp, "meta.json"))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            if self.fsync:
                ckpt_lib.fsync_dir(self.dir)
            # --- durable from here on: commit the host-side baseline ---
            self._sig = sig
            self._last_seq = seq
            self._saves_since_full = (0 if mode == "full"
                                      else self._saves_since_full + 1)
            self.saves[mode] += 1
            self.bytes_written[mode] += nbytes
            self.last_save = {**out, "seq": seq, "copy_ms": copy_ms,
                              "write_ms": (time.perf_counter() - t0) * 1e3}
            self._retain()
            reg = obs.metrics()
            if reg is not None:
                reg.counter(f"checkpoint_{mode}_total").inc()
                reg.gauge("checkpoint_bytes_last").set(nbytes)
                reg.gauge("checkpoint_seq").set(seq)
            if self.on_durable is not None:
                self.on_durable(seq)

        def guarded():
            try:
                write()
            except BaseException as e:  # surfaced via poll_error/wait
                self._error = e
                self.saves["failed"] += 1
                shutil.rmtree(os.path.join(self.dir, f"tmp.{seq}"),
                              ignore_errors=True)
                reg = obs.metrics()
                if reg is not None:
                    reg.counter("checkpoint_failures_total").inc()

        if blocking:
            guarded()
            self.poll_error(raise_=True)
        else:
            self._thread = threading.Thread(
                target=guarded, name="rag-checkpoint", daemon=True)
            self._thread.start()
        return out

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def poll_error(self, raise_: bool = False) -> BaseException | None:
        """Fetch-and-clear the last write failure. The caller decides the
        policy (the supervisor counts it and retries next cadence — the
        journal was not truncated, so nothing was lost)."""
        e, self._error = self._error, None
        if e is not None and raise_:
            raise e
        return e

    # ------------------------------------------------------------ retention
    def _dirs(self) -> list[tuple[int, dict]]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_"):
                continue
            try:
                with open(os.path.join(self.dir, name, "meta.json")) as f:
                    out.append((int(name.split("_")[1]), json.load(f)))
            except (OSError, json.JSONDecodeError):
                continue  # half-removed or corrupt: recovery skips it too
        return out

    def _retain(self) -> None:
        """Keep the last ``keep_full`` full checkpoints, each with its
        complete delta chain; everything older goes."""
        dirs = self._dirs()
        fulls = [seq for seq, meta in dirs if meta["mode"] == "full"]
        if len(fulls) <= self.keep_full:
            return
        cutoff = fulls[-self.keep_full]
        for seq, _meta in dirs:
            if seq < cutoff:
                shutil.rmtree(os.path.join(self.dir, f"step_{seq:012d}"),
                              ignore_errors=True)

    # -------------------------------------------------------------- restore
    def latest_seq(self) -> int | None:
        dirs = self._dirs()
        return dirs[-1][0] if dirs else None

    def restore(self, abstract_tree) -> tuple[Any, dict]:
        """Rebuild the latest checkpointed state: load the newest full
        checkpoint, then apply every later delta in order (small leaves
        replaced, dirty-cluster rows scattered) on the host, and build the
        tree on the abstract tree's devices. Returns (tree, meta of the
        newest checkpoint applied)."""
        dirs = self._dirs()
        if not dirs:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        base_i = max(i for i, (_s, m) in enumerate(dirs)
                     if m["mode"] == "full")
        base_seq, base_meta = dirs[base_i]
        arrays = self._load_arrays(base_seq)
        meta = base_meta
        prev = base_seq
        for seq, m in dirs[base_i + 1:]:
            assert m["mode"] == "delta", \
                f"unexpected full checkpoint {seq} after {base_seq}"
            assert m["prev_seq"] == prev, \
                f"broken delta chain at {seq}: prev {m['prev_seq']} != {prev}"
            delta = self._load_arrays(seq)
            idx = np.asarray(m["dirty"], np.int32)
            axis = m["cluster_axis"]
            for path, a in delta.items():
                if path in PER_CLUSTER_PATHS:
                    _put_rows(arrays[path], idx, a, axis)
                else:
                    arrays[path] = a
            meta, prev = m, seq
        return ckpt_lib.unflatten_arrays(abstract_tree, arrays), meta

    def _load_arrays(self, seq: int) -> dict[str, np.ndarray]:
        z = np.load(os.path.join(self.dir, f"step_{seq:012d}", "arrays.npz"))
        return {k.replace("╱", "/"): np.array(z[k]) for k in z.files}


# ---------------------------------------------------------------------------
# recovery replay

@dataclasses.dataclass
class ReplayReport:
    replayed: int = 0
    quarantined: list[int] = dataclasses.field(default_factory=list)
    last_seq: int = -1
    docs: int = 0


def replay_journal(journal: IngestJournal, start_seq: int,
                   apply_fn: Callable[[np.ndarray, np.ndarray], None], *,
                   quarantine_after: int = 3,
                   skip: frozenset | set = frozenset()) -> ReplayReport:
    """Re-ingest the journal tail through the NORMAL ingest path.

    Each batch gets ``quarantine_after`` attempts; a batch that keeps
    raising a *transient* error is quarantined (recorded, counted, never
    silently dropped) and replay continues — a fatal error propagates.
    The ``replay`` fault point fires before every batch, so a mid-replay
    crash leaves the journal and checkpoints untouched and a second
    recovery simply starts over (replay is idempotent from a restored
    checkpoint)."""
    report = ReplayReport()
    reg, tr = obs.metrics(), obs.tracer()
    span = (tr.span("recovery.replay", cat="ingest", start_seq=start_seq)
            if tr is not None else None)
    for seq, x, ids in journal.replay(start_seq):
        if seq in skip:
            report.quarantined.append(seq)
            report.last_seq = seq
            continue
        attempts = 0
        while True:
            try:
                # inside the retry loop: a transient injected replay
                # fault consumes the quarantine budget like any other
                # failure; an InjectedCrash (BaseException) still escapes
                faults.fault_point("replay", seq=seq)
                apply_fn(x, ids)
                break
            except Exception as e:
                if classify_error(e) == "fatal":
                    raise
                attempts += 1
                if attempts >= quarantine_after:
                    report.quarantined.append(seq)
                    if reg is not None:
                        reg.counter("ingest_quarantined_total").inc()
                    break
        if seq not in report.quarantined:
            report.replayed += 1
            report.docs += int(np.sum(ids >= 0))
        report.last_seq = seq
    if reg is not None:
        reg.counter("recovery_replayed_total").inc(report.replayed)
    if span is not None:
        span.args.update(replayed=report.replayed,
                         quarantined=len(report.quarantined))
        span.end()
    return report


# ---------------------------------------------------------------------------
# runtime-facing glue

@dataclasses.dataclass
class DurabilityConfig:
    """Where and how often the ingest side persists.

    ``checkpoint_every`` counts APPLIED batches between checkpoints;
    deltas reuse the publish dirty signature, so frequent checkpoints of
    a lightly-touched store stay cheap. ``fsync=False`` trades the
    power-failure guarantee for speed (kill -9 of the process is still
    covered by the page cache)."""

    checkpoint_dir: str
    journal_dir: str | None = None     # default: <checkpoint_dir>/journal
    checkpoint_every: int = 16
    keep_full: int = 2
    full_every: int = 0                # force a full every N checkpoints
    segment_bytes: int = 8 << 20
    fsync: bool = True
    quarantine_after: int = 3          # failed replays before quarantine

    def __post_init__(self):
        assert self.checkpoint_every >= 1
        if self.journal_dir is None:
            self.journal_dir = os.path.join(self.checkpoint_dir, "journal")


class DurableIngest:
    """The write-ahead + checkpoint pair one streaming server owns.

    The producer path calls ``record`` (journal append, fsync) BEFORE the
    batch is enqueued; the ingest thread calls ``batch_applied`` after the
    engine accepted it and ``maybe_checkpoint``/``checkpoint`` at cadence.
    Journal truncation happens only from the checkpoint writer's
    ``on_durable`` callback — nothing is dropped before it is covered by
    a checkpoint that actually hit disk."""

    def __init__(self, cfg: DurabilityConfig, *, cluster_axis: int = 0):
        self.cfg = cfg
        self.journal = IngestJournal(cfg.journal_dir,
                                     segment_bytes=cfg.segment_bytes,
                                     fsync=cfg.fsync)
        self.ckpt = CheckpointStore(
            cfg.checkpoint_dir, cluster_axis=cluster_axis,
            keep_full=cfg.keep_full, full_every=cfg.full_every,
            fsync=cfg.fsync, on_durable=self._on_ckpt_durable)
        self._lock = threading.Lock()
        self._next_seq = self.journal.last_seq() + 1
        self._applied_seq = self.ckpt.latest_seq()
        self._applied_seq = -1 if self._applied_seq is None \
            else self._applied_seq
        self._since_ckpt = 0
        self.quarantined: list[int] = []

    # ------------------------------------------------------------- producer
    def record(self, x: np.ndarray, ids: np.ndarray) -> int:
        """Journal one batch ahead of the queue; returns its seq. Callers
        serialize (the runtime holds its producer lock), so seqs match
        queue order — the property replay correctness rests on."""
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
        n = self.journal.append(seq, np.asarray(x), np.asarray(ids))
        reg = obs.metrics()
        if reg is not None:
            reg.counter("journal_appends_total").inc()
            reg.counter("journal_bytes_total").inc(n)
        return seq

    # --------------------------------------------------------- ingest thread
    def batch_applied(self, seq: int) -> None:
        self._applied_seq = seq
        self._since_ckpt += 1
        reg = obs.metrics()
        if reg is not None:
            reg.gauge("journal_lag_batches").set(self.lag_batches())
            reg.gauge("checkpoint_age_batches").set(self._since_ckpt)

    def lag_batches(self) -> int:
        """Batches journaled but not yet applied by the engine."""
        return self.journal.last_seq() - self._applied_seq

    def should_checkpoint(self) -> bool:
        return self._since_ckpt >= self.cfg.checkpoint_every

    def checkpoint(self, tree, *, metadata: dict | None = None,
                   blocking: bool = False, force_full: bool = False) -> dict:
        """Checkpoint ``tree`` as covering everything applied so far.
        Must be called from the ingest thread between batches (the state
        is a consistent batch boundary there by construction)."""
        out = self.ckpt.save(self._applied_seq, tree, metadata=metadata,
                             blocking=blocking, force_full=force_full)
        self._since_ckpt = 0
        return out

    def _on_ckpt_durable(self, seq: int) -> None:
        removed = self.journal.truncate(seq)
        reg = obs.metrics()
        if reg is not None and removed:
            reg.counter("journal_truncated_segments_total").inc(removed)

    # -------------------------------------------------------------- recovery
    def needs_recovery(self) -> bool:
        return (self.ckpt.latest_seq() is not None
                or self.journal.last_seq() >= 0)

    def recover(self, abstract_tree,
                apply_fn: Callable[[np.ndarray, np.ndarray], None],
                restore_fn: Callable[[Any, dict], None]) -> dict:
        """Full supervised recovery: restore the checkpoint chain (if
        any), hand the state to ``restore_fn(tree, meta)``, then replay
        the journal tail through ``apply_fn``. Returns a report dict.

        Bit-identity: checkpoints are taken at applied-batch boundaries
        and replay re-runs the exact journaled batches through the normal
        ingest path, so the recovered state is leaf-for-leaf what the
        uncrashed engine would hold after the same batches."""
        reg, tr = obs.metrics(), obs.tracer()
        span = (tr.span("recovery", cat="ingest")
                if tr is not None else None)
        start_seq, meta = 0, None
        if self.ckpt.latest_seq() is not None:
            tree, meta = self.ckpt.restore(abstract_tree)
            restore_fn(tree, meta)
            start_seq = meta["seq"] + 1
        report = replay_journal(
            self.journal, start_seq, apply_fn,
            quarantine_after=self.cfg.quarantine_after,
            skip=frozenset(self.quarantined))
        for seq in report.quarantined:
            if seq not in self.quarantined:
                self.quarantined.append(seq)
        self._applied_seq = max(start_seq - 1, report.last_seq)
        with self._lock:
            self._next_seq = max(self._next_seq, self._applied_seq + 1)
        self._since_ckpt = 0
        out = {"checkpoint_seq": None if meta is None else meta["seq"],
               "replayed": report.replayed,
               "quarantined": list(report.quarantined),
               "docs_replayed": report.docs,
               "docs_checkpointed": 0 if meta is None
               else meta.get("docs_ingested", 0),
               "applied_seq": self._applied_seq}
        if reg is not None:
            reg.counter("recovery_total").inc()
        if span is not None:
            span.args.update({k: v for k, v in out.items()
                              if k != "quarantined"})
            span.end()
        return out

    # ------------------------------------------------------------ accounting
    def stats(self) -> dict:
        j = self.journal.stats()
        return {
            "journal_last_seq": j["last_seq"],
            "journal_segments": j["segments"],
            "journal_disk_bytes": j["disk_bytes"],
            "journal_lag_batches": self.lag_batches(),
            "applied_seq": self._applied_seq,
            "checkpoint_seq": self.ckpt.latest_seq(),
            "checkpoint_age_batches": self._since_ckpt,
            "checkpoint_saves": dict(self.ckpt.saves),
            "checkpoint_bytes": dict(self.ckpt.bytes_written),
            "quarantined": list(self.quarantined),
        }

    def close(self) -> None:
        self.ckpt.wait()
        self.journal.close()
