"""Structured query log: one JSON record per probe, size-rotated.

This is the input the ROADMAP's workload-adaptive maintenance item
needs: per-probe window/k/budget, per-stage timings, leaf accounting
(including the touched leaf ids per partition, capped), gap reports,
and shard fan-out — enough to drive hot-leaf re-splitting, skew-based
rebalance, and window-distribution-sized BTP partitions offline.

Records are JSON Lines (one object per line) appended to
``query_log.jsonl``; when the live file exceeds ``max_bytes`` it
rotates to ``query_log.1.jsonl`` … ``query_log.<max_files>.jsonl``
(oldest dropped), the same bounded-disk discipline as the WAL it sits
beside.  Appends are serialized by one lock and the file is line
buffered — a crash loses at most the tail line.

Every record carries a monotonic per-log sequence number ``seq``
(assigned under the append lock, so file order == seq order), which is
what lets an offline reader detect rotation losses (first surviving
seq > 0, or a hole where a rotated file was dropped) and dedup
replayed records — a re-read of overlapping rotated files must never
double-count leaf heat.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

__all__ = ["QueryLog", "install_query_log", "get_query_log"]


class QueryLog:
    """Size-rotated JSONL sink for per-probe records."""

    def __init__(self, directory: str, *,
                 max_bytes: int = 16 * 1024 * 1024,
                 max_files: int = 4,
                 name: str = "query_log"):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.max_bytes = max_bytes
        self.max_files = max_files
        self.name = name
        self._lock = threading.Lock()
        self._f = open(self.path, "a", buffering=1)
        self.records_written = 0
        self.rotations = 0
        self._seq = 0

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"{self.name}.jsonl")

    def _rotated(self, i: int) -> str:
        return os.path.join(self.directory, f"{self.name}.{i}.jsonl")

    def _rotate_locked(self) -> None:
        self._f.close()
        oldest = self._rotated(self.max_files)
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.max_files - 1, 0, -1):
            if os.path.exists(self._rotated(i)):
                os.replace(self._rotated(i), self._rotated(i + 1))
        os.replace(self.path, self._rotated(1))
        self._f = open(self.path, "a", buffering=1)
        self.rotations += 1

    def record(self, rec: dict) -> Optional[dict]:
        """Append one probe record (adds a wall-clock ``t`` stamp and
        the monotonic ``seq`` — assigned under the lock, so seq order
        is file order even under concurrent probe threads).  Returns
        the stamped copy that was persisted (None when closed), so
        live probe observers see the same ``seq``/``t`` the file
        holds."""
        rec = dict(rec)
        rec.setdefault("t", time.time())
        with self._lock:
            if self._f.closed:
                return None
            rec["seq"] = self._seq
            self._seq += 1
            line = json.dumps(rec, separators=(",", ":"),
                              default=_jsonable) + "\n"
            self._f.write(line)
            self.records_written += 1
            if self._f.tell() >= self.max_bytes:
                self._rotate_locked()
        return rec

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def _jsonable(v):
    import numpy as np
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(f"not JSON serializable: {type(v)}")


_LOG: Optional[QueryLog] = None


def install_query_log(log: Optional[QueryLog]) -> Optional[QueryLog]:
    """Install (or, with ``None``, remove) the process-global query
    log the probe entry points write to.  Returns the previous one."""
    global _LOG
    prev, _LOG = _LOG, log
    return prev


def get_query_log() -> Optional[QueryLog]:
    return _LOG
