"""Persistent storage: on-disk segments, manifest store, external-sort
bulk load, tiers.

* :mod:`repro_torch.storage.packing` — format-v3 codecs (bit-packed codes,
  delta+varint keys), byte-identical to the reference's;
* :mod:`repro_torch.storage.segment` — the segment file (writer, mmap
  reader, ``to_tree``, :func:`exact_search_mmap`);
* :mod:`repro_torch.storage.store` — :class:`SegmentStore` (segment files
  under an atomically committed ``MANIFEST.json``, crash recovery, GC)
  and :class:`ShardDirectory` (``SHARDS.json`` over shard stores), the
  JSON byte for byte the reference's;
* :mod:`repro_torch.storage.external_sort` — :func:`build_external`;
* :mod:`repro_torch.storage.cache` / :mod:`repro_torch.storage.tiers` —
  the byte-budgeted clock cache and the device/host/mmap leaf store.
"""
from .cache import CacheEntry, ClockCache, QueryResultCache
from .external_sort import build_external
from .segment import (Segment, SegmentFormatError, SegmentWriter,
                      exact_search_mmap, write_segment)
from .store import SegmentStore, ShardDirectory
from .tiers import TieredLeafStore

__all__ = ["Segment", "SegmentWriter", "SegmentFormatError",
           "SegmentStore", "ShardDirectory",
           "build_external", "exact_search_mmap", "write_segment",
           "ClockCache", "QueryResultCache", "CacheEntry",
           "TieredLeafStore"]
