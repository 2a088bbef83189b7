"""Snapshot-versioned exact result cache with precise delta invalidation.

Level 2 of the hot-set serving cache: a bounded LRU over *exact* answers,
keyed on (embedding signature, plan bucket, snapshot version). The cache
is snapshot-correct by construction, not by heuristics:

  * a final two-stage answer is a pure function of (the query vector, the
    ordered route list stage 1 selected, the routed clusters' ring
    contents, the plan bucket). Stage 1 only *selects* routes — so an
    entry is servable iff the query bytes and plan bucket match, the
    entry is current for the pinned snapshot version, AND the routes the
    current snapshot selects for the query equal the entry's recorded
    routes. The route-equality check (routes are in hand at flush time —
    the runtime runs a batch route pass for tracking anyway) makes index
    or routing drift harmless without any conservative flush-the-world
    logic: an entry whose routing moved simply misses.
  * delta publication invalidates *precisely*: ``last_publish_info``'s
    dirty-cluster set names every cluster whose rings can have changed
    ((cluster counts, ring ptr, rep id) is an exact monotone change
    detector — see ``Engine._update_publish_info``). ``on_publish``
    evicts only the entries whose recorded route set intersects the dirty
    set and re-keys every survivor to the new version — their routed
    rings are untouched, so their answers are still bit-identical to a
    fresh compute. A publish with no dirty information (``dirty=None``,
    e.g. a full rebuild with no delta baseline) clears the cache —
    correctness never leans on a guess.

Embedding signatures are blake2b digests of the raw query bytes; the
entry keeps the exact bytes and verifies them on hit, so a digest
collision can never serve a wrong answer. All methods take an internal
lock — the runtime may flush from multiple caller threads.
"""
from __future__ import annotations

import collections
import hashlib
import threading

import numpy as np


def _digest(qbytes: bytes, plan_key: str) -> bytes:
    h = hashlib.blake2b(qbytes, digest_size=16)
    h.update(plan_key.encode())
    return h.digest()


class _Entry:
    __slots__ = ("qbytes", "plan_key", "routes", "answer", "version",
                 "birth_version", "verified_version")

    def __init__(self, qbytes, plan_key, routes, answer, version):
        self.qbytes = qbytes
        self.plan_key = plan_key
        self.routes = routes            # [nprobe] i32, ordered, -1 = no route
        self.answer = answer            # (scores, rows, doc_ids, clusters)
        self.version = version          # snapshot version the entry is
        #                                 current for (bumped by on_publish)
        self.birth_version = version    # version the answer was computed at
        self.verified_version = version  # version the routes were last
        #                                  verified (computed or recheck-hit)


class ResultCache:
    """Bounded LRU of exact per-query answers (see module docstring)."""

    def __init__(self, max_entries: int):
        assert max_entries > 0, "ResultCache needs a positive capacity"
        self.max_entries = max_entries
        self._entries: collections.OrderedDict[bytes, _Entry] = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.hits_exact = 0      # served by the route-free peek_exact path
        self.misses = 0
        self.invalidated = 0     # evicted by a dirty-route publish
        self.cleared = 0         # evicted by a no-dirty-info publish
        self.evicted_lru = 0
        self.rekeyed = 0         # survived a publish (clean routes)
        # misses of a current entry whose query now routes elsewhere
        self.routes_moved = 0
        self.hit_staleness_sum = 0   # publishes each hit's answer survived

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------ query
    def peek_exact(self, qbytes: bytes, plan_key: str, version: int):
        """Route-free fast path: return the cached answer iff the entry
        is current for ``version`` AND its routes were verified at this
        exact version (computed under it, or route-checked by a previous
        ``lookup``). Within one snapshot version stage-1 routing is a
        pure function of the query, so re-deriving the routes for such
        an entry is a no-op by determinism — the caller may skip the
        route pass entirely. Returns None without counting a miss (the
        caller falls through to the verifying ``lookup``)."""
        key = _digest(qbytes, plan_key)
        with self._lock:
            e = self._entries.get(key)
            if (e is not None and e.qbytes == qbytes
                    and e.plan_key == plan_key and e.version == version
                    and e.verified_version == version):
                self._entries.move_to_end(key)
                self.hits += 1
                self.hits_exact += 1
                self.hit_staleness_sum += e.version - e.birth_version
                return e.answer
            return None

    def lookup(self, qbytes: bytes, plan_key: str, version: int,
               routes: np.ndarray):
        """Return the cached (scores, rows, doc_ids, clusters) for this
        (query, plan bucket) iff it is exact for ``version`` and the
        freshly routed ``routes`` — else None (and a miss is counted).
        A hit marks the routes verified at ``version``, arming the
        route-free ``peek_exact`` path for subsequent flushes pinned to
        the same snapshot."""
        key = _digest(qbytes, plan_key)
        with self._lock:
            e = self._entries.get(key)
            if (e is not None and e.qbytes == qbytes
                    and e.plan_key == plan_key and e.version == version):
                if np.array_equal(e.routes, routes):
                    self._entries.move_to_end(key)
                    e.verified_version = version
                    self.hits += 1
                    self.hit_staleness_sum += e.version - e.birth_version
                    return e.answer
                self.routes_moved += 1
            self.misses += 1
            return None

    def insert(self, qbytes: bytes, plan_key: str, version: int,
               routes: np.ndarray, answer) -> None:
        key = _digest(qbytes, plan_key)
        with self._lock:
            self._entries[key] = _Entry(qbytes, plan_key,
                                        np.asarray(routes, np.int32).copy(),
                                        answer, version)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evicted_lru += 1

    # ---------------------------------------------------------- invalidation
    def on_publish(self, version: int, dirty) -> None:
        """Apply one publication: evict entries routed through a dirty
        cluster, re-key clean survivors to ``version``. ``dirty`` is the
        publish's dirty-cluster index array (empty = republish, nothing
        moved) or None (no exact dirty info -> clear everything)."""
        with self._lock:
            if dirty is None:
                self.cleared += len(self._entries)
                self._entries.clear()
                return
            dirty_set = np.asarray(dirty).ravel()
            for key in list(self._entries):
                e = self._entries[key]
                live = e.routes[e.routes >= 0]
                if dirty_set.size and np.isin(live, dirty_set).any():
                    del self._entries[key]
                    self.invalidated += 1
                else:
                    e.version = version
                    self.rekeyed += 1

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "hits": self.hits,
                "hits_exact": self.hits_exact,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "invalidated": self.invalidated,
                "cleared": self.cleared,
                "evicted_lru": self.evicted_lru,
                "rekeyed": self.rekeyed,
                # publishes the average hit's answer had survived — the
                # bounded-staleness number (answers are exact regardless)
                "hit_staleness": (self.hit_staleness_sum / self.hits
                                  if self.hits else 0.0),
            }
