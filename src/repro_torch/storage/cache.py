"""Byte-budgeted clock cache and query-result LRU for the tiered store.

Two small, thread-safe primitives — policy only, no tier semantics (that
lives in :mod:`repro_torch.storage.tiers`):

* :class:`ClockCache` — a second-chance ("clock") cache with a byte
  budget.  Clock approximates LRU with O(1) touch cost (set a reference
  bit; no list splicing on the read path), which is the right trade for
  a cache consulted on every leaf of every probe.  Keys are opaque
  tuples; a per-group index makes invalidating a whole segment's leaves
  O(entries of that segment), not O(cache).

* :class:`QueryResultCache` — a bounded LRU keyed by the full identity
  of an exact probe ``(query PAA bytes, window, k, radius, snapshot
  epoch, mode)``.  Entry count, not bytes, bounds it: values are [k]
  answer pairs, tiny and uniform.  Correctness comes entirely from the
  snapshot epoch in the key — any flush/merge/rebalance bumps the epoch
  and every older entry becomes unreachable (and ages out by LRU).
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Hashable, Optional, Set, Tuple

__all__ = ["ClockCache", "QueryResultCache", "CacheEntry"]


class CacheEntry:
    """One resident block: the value, its resident byte cost, the clock
    reference bit, a touch count (promotion signal), and whether the
    value lives on device."""

    __slots__ = ("value", "nbytes", "ref", "touches", "device")

    def __init__(self, value: Any, nbytes: int):
        self.value = value
        self.nbytes = int(nbytes)
        self.ref = True
        self.touches = 1
        self.device = False


class ClockCache:
    """Second-chance eviction over a byte budget.

    The ring is a deque of keys with lazy tombstones: removal just drops
    the map entry, and the sweep discards ring slots whose key no longer
    maps.  The sweep gives each referenced entry one more pass (clear
    ref, re-append), so a full rotation evicts the first entry not
    touched since the hand last passed it — within 2·n pops the sweep
    must yield a victim, hence the bounded loop.
    """

    def __init__(self, capacity_bytes: int, *,
                 on_evict: Optional[Callable[[Hashable, CacheEntry],
                                             None]] = None):
        self.capacity_bytes = int(capacity_bytes)
        self._on_evict = on_evict
        self._lock = threading.Lock()
        self._map: Dict[Hashable, CacheEntry] = {}
        self._ring: deque = deque()
        self._groups: Dict[Hashable, Set[Hashable]] = {}
        self._bytes = 0
        self.evictions = 0
        self.insertions = 0

    @staticmethod
    def _group_of(key: Hashable) -> Hashable:
        return key[0] if isinstance(key, tuple) else key

    def get(self, key: Hashable) -> Optional[CacheEntry]:
        """The entry (ref bit set, touches bumped) or None."""
        with self._lock:
            ent = self._map.get(key)
            if ent is None:
                return None
            ent.ref = True
            ent.touches += 1
            return ent

    def put(self, key: Hashable, value: Any, nbytes: int
            ) -> Optional[CacheEntry]:
        """Admit a block, evicting by clock until it fits.  Blocks larger
        than the whole budget are refused (returns None)."""
        nbytes = int(nbytes)
        if nbytes > self.capacity_bytes:
            return None
        with self._lock:
            old = self._map.get(key)
            if old is not None:
                self._remove_locked(key, old)
            while self._bytes + nbytes > self.capacity_bytes:
                if not self._evict_one_locked():
                    return None
            ent = CacheEntry(value, nbytes)
            self._map[key] = ent
            self._ring.append(key)
            self._groups.setdefault(self._group_of(key), set()).add(key)
            self._bytes += nbytes
            self.insertions += 1
            return ent

    def account(self, key: Hashable, delta_bytes: int) -> None:
        """Re-charge a resident entry whose byte cost changed (e.g. a
        decoded block replacing a packed one on promotion)."""
        with self._lock:
            if key in self._map:
                self._map[key].nbytes += int(delta_bytes)
                self._bytes += int(delta_bytes)

    def remove(self, key: Hashable) -> None:
        with self._lock:
            ent = self._map.get(key)
            if ent is not None:
                self._remove_locked(key, ent)

    def invalidate_group(self, group: Hashable) -> int:
        """Drop every key whose first tuple element is ``group`` (all
        cached leaves of one segment).  Returns entries dropped."""
        with self._lock:
            keys = self._groups.pop(group, None)
            if not keys:
                return 0
            n = 0
            for key in list(keys):
                ent = self._map.get(key)
                if ent is not None:
                    self._remove_locked(key, ent, _group_known=True)
                    n += 1
            return n

    def clear(self) -> None:
        with self._lock:
            for key, ent in list(self._map.items()):
                self._remove_locked(key, ent)

    # ------------------------------------------------------------- internals
    def _remove_locked(self, key, ent, _group_known: bool = False) -> None:
        # ring slot becomes a lazy tombstone; the sweep skips it
        del self._map[key]
        self._bytes -= ent.nbytes
        if not _group_known:
            grp = self._groups.get(self._group_of(key))
            if grp is not None:
                grp.discard(key)
                if not grp:
                    del self._groups[self._group_of(key)]
        if self._on_evict is not None:
            self._on_evict(key, ent)

    def _evict_one_locked(self) -> bool:
        for _ in range(2 * len(self._ring) + 1):
            if not self._ring:
                return False
            key = self._ring.popleft()
            ent = self._map.get(key)
            if ent is None:
                continue                       # tombstone
            if ent.ref:
                ent.ref = False
                self._ring.append(key)         # second chance
                continue
            self._remove_locked(key, ent)
            self.evictions += 1
            return True
        return False

    # ------------------------------------------------------------- readouts
    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._map


class QueryResultCache:
    """Bounded LRU of exact-probe answers.

    ``get``/``put`` take the full key tuple built by the caller — the
    snapshot epoch inside it is what makes stale entries unreachable
    after any flush/merge/rebalance, so this cache never needs an
    explicit invalidation hook.
    """

    def __init__(self, max_entries: int = 512):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._map: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple) -> Optional[Any]:
        with self._lock:
            try:
                val = self._map[key]
            except KeyError:
                self.misses += 1
                return None
            self._map.move_to_end(key)
            self.hits += 1
            return val

    def put(self, key: Tuple, value: Any) -> None:
        with self._lock:
            self._map[key] = value
            self._map.move_to_end(key)
            while len(self._map) > self.max_entries:
                self._map.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._map.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)
