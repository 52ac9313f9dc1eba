"""Heat-driven tiered leaf store: device-hot, host-warm, mmap-cold.

"Data Series Indexing Gone Parallel" (PAPERS.md) makes the scan
compute-bound by keeping the hot summarization columns resident;
Coconut's sortable layout makes residency *leaf-granular* — every column
is leaf-contiguous on disk, so a leaf is both the pruning unit and the
natural cache block.  This module stacks three tiers under the
:class:`repro_torch.query.partition.Partition` seam:

* **cold** — the mmap'd v3 segment columns, exactly as before.  First
  touch of a leaf reads its packed bytes, charges ``io.bytes_read``, and
  admits the block to the warm tier.
* **warm** — a byte-budgeted host-RAM :class:`ClockCache` of packed code
  blocks and decoded key blocks.  A hit serves the block with zero disk
  I/O and charges ``cache.bytes_saved`` instead of ``io.bytes_read``
  (the two currencies never mix, so the analytics gate's bit-exact
  byte accounting still certifies).
* **hot** — leaves whose clock touch count crosses ``promote_touches``
  get their packed code block copied to the asking partition's device
  as a torch tensor, inside a smaller device byte budget.  The
  executor's ``unpack_mindist`` kernel then scans them without a
  host→device transfer per probe.

Admission is purely demand + touch heat — the same per-leaf touch
signal the reference's workload analytics aggregate into leaf heat,
observed here at its source.  Invalidation is two-sided:

* leaf blocks are keyed by segment path, and segment files are
  immutable-once-published with never-reused ids, so the only
  invalidation event is a segment leaving the store (GC after
  flush/merge/rebalance) — :meth:`TieredLeafStore.invalidate` drops that
  group;
* whole-probe answers in the :class:`QueryResultCache` are keyed by the
  snapshot's **data epoch** (bumped on every buffer insert, run publish,
  and merge), so a result computed against an older view is simply
  unreachable.

Everything is mirrored into the obs registry under ``cache.*``.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Hashable, List, Optional, Tuple

import numpy as np
import torch

from ..obs.registry import MetricsRegistry, get_registry
from .cache import CacheEntry, ClockCache, QueryResultCache

__all__ = ["TieredLeafStore"]


class TieredLeafStore:
    """The shared leaf-block cache handed to every Partition of an LSM
    (or one per shard).  Thread-safe: concurrent probes hit it from the
    executor pool.

    ``capacity_bytes`` bounds host-resident block bytes;
    ``device_capacity_bytes`` (default: a quarter of it) separately
    bounds the subset additionally promoted to device.
    """

    def __init__(self, capacity_bytes: int, *,
                 device_capacity_bytes: Optional[int] = None,
                 promote_touches: int = 4,
                 result_entries: int = 512,
                 registry: Optional[MetricsRegistry] = None):
        self.cache = ClockCache(int(capacity_bytes),
                                on_evict=self._on_evict)
        self.device_capacity_bytes = (
            int(capacity_bytes) // 4 if device_capacity_bytes is None
            else int(device_capacity_bytes))
        self.promote_touches = int(promote_touches)
        self.result_cache = QueryResultCache(result_entries)
        self._reg = registry if registry is not None else get_registry()
        self._dev_lock = threading.Lock()
        self._device_bytes = 0
        # invalidation fan-out: other device-resident caches (the mesh
        # scan engine's pinned shard columns) subscribe here so segment
        # GC after flush/merge/rebalance drops THEIR state too
        self._inval_hooks: List[Callable[[Optional[Hashable]], None]] = []
        # own monotone totals (the registry is process-global; these are
        # this store's view of its own traffic)
        self.hits = 0
        self.misses = 0
        self.bytes_saved = 0
        self.promotions = 0
        # eager registration: the full cache.* family is present in the
        # /metrics exposition from the first scrape, not first touch
        for c in ("hits", "misses", "bytes_saved", "promotions",
                  "evictions", "insertions", "result_hits",
                  "result_misses"):
            self._reg.counter(f"cache.{c}")
        self._publish_gauges()

    # ------------------------------------------------------------ leaf blocks
    def get(self, token: Hashable, col: str, leaf: int,
            stored_nbytes: int, device=None) -> Optional[Any]:
        """The cached block for (segment, column, leaf) or None.

        ``stored_nbytes`` is what the block costs to read off disk —
        the amount a hit credits to ``cache.bytes_saved`` in place of
        the ``io.bytes_read`` charge a miss would incur.  ``device``: where
        a code block promoted by this hit goes (the asking partition's
        device; the card when not given).
        """
        ent = self.cache.get((token, col, leaf))
        if ent is None:
            self.misses += 1
            self._reg.counter("cache.misses").inc()
            return None
        self.hits += 1
        self.bytes_saved += int(stored_nbytes)
        self._reg.counter("cache.hits").inc()
        self._reg.counter("cache.bytes_saved").inc(int(stored_nbytes))
        if (col == "codes" and not ent.device
                and ent.touches >= self.promote_touches):
            self._promote(ent, device)
        return ent.value

    def admit(self, token: Hashable, col: str, leaf: int,
              value: np.ndarray, stored_nbytes: int) -> None:
        """Admit a freshly-read block to the warm tier (demand fill)."""
        ent = self.cache.put((token, col, leaf), value,
                             int(value.nbytes))
        if ent is not None:
            self._reg.counter("cache.insertions").inc()
        self._publish_gauges()

    def _promote(self, ent: CacheEntry, device=None) -> None:
        """Copy a hot packed-code block to ``device``, within budget."""
        with self._dev_lock:
            if ent.device:
                return
            if self._device_bytes + ent.nbytes > self.device_capacity_bytes:
                return
            self._device_bytes += ent.nbytes
            ent.device = True
        dev = torch.device("cuda" if device is None else device)
        ent.value = torch.from_numpy(np.array(ent.value)).to(dev)
        self.promotions += 1
        self._reg.counter("cache.promotions").inc()
        self._reg.gauge("cache.device_bytes").set(self._device_bytes)

    def _on_evict(self, key, ent: CacheEntry) -> None:
        self._reg.counter("cache.evictions").inc()
        if ent.device:
            with self._dev_lock:
                self._device_bytes -= ent.nbytes
                ent.device = False

    # ----------------------------------------------------------- invalidation
    def add_invalidation_hook(
            self, fn: Callable[[Optional[Hashable]], None]) -> None:
        """Subscribe ``fn(token)`` to every invalidation event.  Called
        with the retired segment token on :meth:`invalidate` and with
        ``None`` on :meth:`clear`.  Hooks must be cheap and must not
        raise (they run on the compactor/rebalance thread)."""
        self._inval_hooks.append(fn)

    def _fire_invalidation(self, token: Optional[Hashable]) -> None:
        for fn in list(self._inval_hooks):
            fn(token)

    def invalidate(self, token: Hashable) -> int:
        """Drop every cached leaf of one segment (called when the
        segment file is garbage-collected after a merge/rebalance)."""
        n = self.cache.invalidate_group(token)
        self._publish_gauges()
        self._fire_invalidation(token)
        return n

    def clear(self) -> None:
        self.cache.clear()
        self.result_cache.clear()
        self._publish_gauges()
        self._fire_invalidation(None)

    # ----------------------------------------------------------- result cache
    def result_get(self, key: Tuple) -> Optional[Any]:
        val = self.result_cache.get(key)
        self._reg.counter("cache.result_hits" if val is not None
                          else "cache.result_misses").inc()
        return val

    def result_put(self, key: Tuple, value: Any) -> None:
        self.result_cache.put(key, value)

    # --------------------------------------------------------------- readouts
    def _publish_gauges(self) -> None:
        self._reg.gauge("cache.resident_bytes").set(
            self.cache.resident_bytes)
        self._reg.gauge("cache.entries").set(len(self.cache))
        self._reg.gauge("cache.device_bytes").set(self._device_bytes)

    @property
    def device_bytes(self) -> int:
        with self._dev_lock:
            return self._device_bytes

    def stats(self) -> dict:
        """Point-in-time summary of the store's counters."""
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
            "bytes_saved": self.bytes_saved,
            "resident_bytes": self.cache.resident_bytes,
            "device_bytes": self.device_bytes,
            "entries": len(self.cache),
            "promotions": self.promotions,
            "evictions": self.cache.evictions,
            "insertions": self.cache.insertions,
            "result_hits": self.result_cache.hits,
            "result_misses": self.result_cache.misses,
        }
