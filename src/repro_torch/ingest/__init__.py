"""Streaming-ingestion subsystem: WAL durability, snapshot reads,
background compaction.

  * :mod:`repro_torch.ingest.wal`       — checksummed write-ahead log,
    byte-compatible with the reference's; acked inserts survive a crash
    and replay on ``CoconutLSM.open``.
  * :mod:`repro_torch.ingest.snapshot`  — immutable read views (frozen
    run list + frozen buffer); queries never block on, or observe, a
    half-finished flush or merge.
  * :mod:`repro_torch.ingest.compactor` — worker thread retiring
    flush/merge/commit debt off the insert path, with bounded-debt
    backpressure.
"""
from .compactor import Compactor
from .snapshot import FrozenBuffer, Snapshot
from .wal import FSYNC_POLICIES, WALCorruptionError, WriteAheadLog

__all__ = ["Compactor", "FrozenBuffer", "Snapshot", "WriteAheadLog",
           "WALCorruptionError", "FSYNC_POLICIES"]
