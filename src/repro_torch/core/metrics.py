"""Disk-access-model accounting, carried onto the GPU memory hierarchy.

The paper analyzes construction/query/update cost in the disk access model
(Aggarwal & Vitter): cost = #blocks moved between memory and storage, with
sequential runs far cheaper than random block touches.  On a GPU the analogous
costs are contiguous HBM streams vs gathers.  We keep the paper's *counts* so
its complexity claims (O(N/B) bulk-load vs O(N) top-down, etc.) can be
validated numerically, and translate to bytes for the roofline.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import defaultdict
from typing import Dict

from ..obs.registry import get_registry


@dataclasses.dataclass
class IOStats:
    """Block-level accounting.  ``block_series``: entries per block (paper: B).

    Counter updates are serialized by a lock: with background compaction the
    flush/merge path and the query path charge the same ``IOStats`` from
    different threads, and ``dict[k] += v`` is not atomic in CPython.

    Every increment is also mirrored into the global metrics registry under
    ``io.<key>`` — per-instance counters stay authoritative for each engine /
    query, the registry aggregates the same traffic process-wide.
    """
    block_series: int = 2000
    counters: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    _mirror: Dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def _add(self, key: str, v: int) -> None:
        with self._lock:
            self.counters[key] += v
            c = self._mirror.get(key)
            if c is None:
                c = self._mirror[key] = get_registry().counter(f"io.{key}")
        c.inc(v)

    def seq_read(self, n_entries: int) -> None:
        self._add("seq_read_blocks", self._blocks(n_entries))

    def seq_write(self, n_entries: int) -> None:
        self._add("seq_write_blocks", self._blocks(n_entries))

    def rand_read(self, n_blocks: int = 1) -> None:
        self._add("rand_read_blocks", n_blocks)

    def rand_write(self, n_blocks: int = 1) -> None:
        self._add("rand_write_blocks", n_blocks)

    # -- real-byte accounting (the on-disk segment store charges these) -----
    def read_bytes(self, n: int) -> None:
        """Actual bytes read from persistent storage (mmap page touches)."""
        self._add("bytes_read", int(n))

    def write_bytes(self, n: int) -> None:
        """Actual bytes written to persistent storage."""
        self._add("bytes_written", int(n))

    def _blocks(self, n_entries: int) -> int:
        return max(1, -(-n_entries // self.block_series))

    @property
    def total_blocks(self) -> int:
        with self._lock:
            return sum(v for k, v in self.counters.items()
                       if k.endswith("_blocks"))

    @property
    def bytes_read(self) -> int:
        with self._lock:
            return self.counters["bytes_read"]

    @property
    def bytes_written(self) -> int:
        with self._lock:
            return self.counters["bytes_written"]

    @property
    def random_blocks(self) -> int:
        with self._lock:
            return (self.counters["rand_read_blocks"]
                    + self.counters["rand_write_blocks"])

    @property
    def sequential_blocks(self) -> int:
        with self._lock:
            return (self.counters["seq_read_blocks"]
                    + self.counters["seq_write_blocks"])

    def merged(self, other: "IOStats") -> "IOStats":
        """Sum of two accountings in a fresh ``IOStats``.

        ``self.block_series`` wins: the result reports blocks in the
        *receiver's* block size even if ``other`` was configured with a
        different one (block counts are summed as charged, never
        rescaled).  The merged counters are written directly, not via
        ``_add``, so they are NOT re-mirrored into the registry — the
        two inputs already were.
        """
        out = IOStats(self.block_series)
        with self._lock:
            for k, v in self.counters.items():
                out.counters[k] += v
        with other._lock:
            for k, v in other.counters.items():
                out.counters[k] += v
        return out

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            d = dict(self.counters)
        d["total_blocks"] = sum(v for k, v in d.items()
                                if k.endswith("_blocks"))
        return d
