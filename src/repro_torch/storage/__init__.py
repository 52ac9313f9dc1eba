"""Persistent storage: on-disk segments, external-sort bulk load, tiers.

* :mod:`repro_torch.storage.packing` — format-v3 codecs (bit-packed codes,
  delta+varint keys), byte-identical to the reference's;
* :mod:`repro_torch.storage.segment` — the segment file (writer, mmap
  reader, ``to_tree``, :func:`exact_search_mmap`);
* :mod:`repro_torch.storage.external_sort` — :func:`build_external`;
* :mod:`repro_torch.storage.cache` / :mod:`repro_torch.storage.tiers` —
  the byte-budgeted clock cache and the device/host/mmap leaf store.

The reference's manifest store (``storage/store.py``) serves the LSM and
the WAL and comes with the port of the streaming layer.
"""
from .cache import CacheEntry, ClockCache, QueryResultCache
from .external_sort import build_external
from .segment import (Segment, SegmentFormatError, SegmentWriter,
                      exact_search_mmap, write_segment)
from .tiers import TieredLeafStore

__all__ = ["Segment", "SegmentWriter", "SegmentFormatError",
           "build_external", "exact_search_mmap", "write_segment",
           "ClockCache", "QueryResultCache", "CacheEntry",
           "TieredLeafStore"]
