"""Host-side streaming data pipeline: prefetch and stream offsets.

Ingest never blocks on the card: a background prefetch thread keeps a
bounded queue, and the *stream offset* is part of the checkpoint so a
restart resumes exactly once. The bounded queue is also the straggler
policy: when the consumer lags, the oldest queued batch is dropped
(freshness beats completeness for streams). ``shard_batch`` places a
batch on a mesh, split along its data axes.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Iterator

import torch

from repro_torch.distributed.sharding import NamedSharding, P, put


class PrefetchLoader:
    """Background-thread prefetch with bounded drop-oldest queue."""

    def __init__(self, batch_fn: Callable[[], dict], depth: int = 4,
                 drop_oldest: bool = True):
        self.batch_fn = batch_fn
        self.depth = depth
        self.drop_oldest = drop_oldest
        self._q: collections.deque = collections.deque(maxlen=depth if drop_oldest else None)
        self._sem = threading.Semaphore(0)
        self._space = threading.Semaphore(depth)
        self._stop = threading.Event()
        self.dropped = 0
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        while not self._stop.is_set():
            batch = self.batch_fn()
            if self.drop_oldest:
                if len(self._q) == self.depth:
                    self.dropped += 1  # backpressure: shed the stalest batch
                    try:
                        self._q.popleft()
                        self._sem.acquire(blocking=False)
                    except IndexError:
                        pass
                self._q.append(batch)
                self._sem.release()
            else:
                self._space.acquire()
                self._q.append(batch)
                self._sem.release()

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        self._sem.acquire()
        batch = self._q.popleft()
        if not self.drop_oldest:
            self._space.release()
        return batch

    def close(self):
        self._stop.set()


class OffsetTracker:
    """Stream-offset bookkeeping for exactly-once resume."""

    def __init__(self, offset: int = 0):
        self.offset = offset

    def advance(self, n: int):
        self.offset += n

    def state_dict(self) -> dict:
        return {"offset": self.offset}

    def load_state_dict(self, d: dict):
        self.offset = int(d["offset"])


def skip_to(stream, offset: int, batch: int):
    """Fast-forward a TopicStream to a checkpointed offset (deterministic
    generators replay identically, so skipping re-synchronizes)."""
    seen = 0
    while seen < offset:
        stream.next_batch(min(batch, offset - seen))
        seen += min(batch, offset - seen)
    return stream


def shard_batch(batch: dict, mesh, data_axes: tuple[str, ...] = ("data",)) -> dict:
    """Place a batch onto the mesh: each entry of rank >= 1 split along dim
    0 over the product of ``data_axes`` (and replicated over the other
    axes), a 0-d entry replicated. A leading dim that does not divide
    raises ``ValueError``."""
    out = {}
    for k, v in batch.items():
        v = v if torch.is_tensor(v) else torch.as_tensor(v)
        spec = P(tuple(data_axes)) if v.dim() >= 1 else P()
        out[k] = put(v, NamedSharding(mesh, spec))
    return out
