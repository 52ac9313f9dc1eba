"""Streaming-ingestion subsystem: snapshot reads and background compaction.

  * :mod:`repro_torch.ingest.snapshot`  — immutable read views (frozen
    run list + frozen buffer); queries never block on, or observe, a
    half-finished flush or merge.
  * :mod:`repro_torch.ingest.compactor` — worker thread retiring
    flush/merge debt off the insert path, with bounded-debt backpressure.

The write-ahead log (``ingest/wal.py`` of the reference) comes with the
durable engine, ROADMAP queue A item 4b.
"""
from .compactor import Compactor
from .snapshot import FrozenBuffer, Snapshot

__all__ = ["Compactor", "FrozenBuffer", "Snapshot"]
