"""SegmentStore: a directory of segments + an atomically-committed manifest.

The LSM structure (levels, runs, clock) lives in ``MANIFEST.json``; segment
files are immutable once finalized.  All mutations follow the classic LSM
commit protocol:

    1. write + fsync the new segment file(s)           (crash => orphan)
    2. write MANIFEST.json.tmp, fsync, os.replace      (the commit point)
    3. delete segment files no longer referenced       (crash => orphan)

``os.replace`` is atomic on POSIX, so the manifest always names a
consistent set of finalized segments: a crash *anywhere* leaves either the
old or the new manifest, plus possibly some orphan files that
:meth:`SegmentStore.recover` removes on the next open.  The in-memory
write buffer is covered separately by the write-ahead log
(:mod:`repro_torch.ingest.wal`): ``wal-NNNNNN.log`` files live beside
the segments, the manifest's ``wal_start`` marks how much of the insert
stream the committed runs already contain, and the WAL is rotated down to
the still-buffered tail right after each manifest commit.  Recovery and
GC here deliberately leave ``wal-*`` files alone — they belong to the
log's own rotation protocol.

``MANIFEST.json`` and ``SHARDS.json`` are written with the reference's
``json.dump`` settings and key order, so for the same content they are
byte for byte the reference's files and either package opens the other's
store.  A run's segment is written from its tree's columns wherever they
live: :func:`~repro_torch.storage.segment.write_segment` copies each
column of a tree on the card to the host (a pageable copy) before the
file write.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Dict, List, Optional

from ..core import summarization as S
from ..core.metrics import IOStats
from .segment import Segment, SegmentFormatError, write_segment

__all__ = ["SegmentStore", "ShardDirectory", "MANIFEST_NAME", "SHARDS_NAME"]

MANIFEST_NAME = "MANIFEST.json"
SHARDS_NAME = "SHARDS.json"
_SEG_RE = re.compile(r"^seg-(\d{6})\.coco$")
_SHARD_DIR_RE = re.compile(r"^shard-\d{3}-g\d+$")
MANIFEST_VERSION = 1
SHARDS_VERSION = 1


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_json_atomic(path: str, obj: dict) -> None:
    """Write + fsync ``path.tmp``, then ``os.replace`` — the one atomic
    commit primitive shared by per-shard manifests and the top-level
    shard manifest.  A crash leaves either the old file or the new one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


@dataclasses.dataclass
class SegmentStore:
    """Manages ``root/seg-NNNNNN.coco`` files and ``root/MANIFEST.json``."""
    root: str
    io: Optional[IOStats] = None

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)
        self._next_id = 1 + max(
            [int(m.group(1)) for f in os.listdir(self.root)
             if (m := _SEG_RE.match(f))] or [0])

    # --------------------------------------------------------------- manifest
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST_NAME)

    def exists(self) -> bool:
        return os.path.exists(self.manifest_path)

    def load_manifest(self) -> Optional[dict]:
        if not self.exists():
            return None
        with open(self.manifest_path) as f:
            m = json.load(f)
        if m.get("version") != MANIFEST_VERSION:
            raise SegmentFormatError(
                f"{self.manifest_path}: unknown manifest version")
        return m

    def commit_manifest(self, manifest: dict) -> None:
        """Atomic manifest replace — THE commit point for every mutation."""
        manifest = dict(manifest, version=MANIFEST_VERSION)
        write_json_atomic(self.manifest_path, manifest)
        if self.io is not None:
            self.io.rand_write(1)

    @staticmethod
    def manifest_for(cfg: S.SummaryConfig, runs: List[dict],
                     **extra) -> dict:
        return {
            "version": MANIFEST_VERSION,
            "cfg": {"series_len": cfg.series_len,
                    "segments": cfg.segments, "bits": cfg.bits},
            "runs": runs,
            **extra,
        }

    @staticmethod
    def cfg_from_manifest(manifest: dict) -> S.SummaryConfig:
        return S.SummaryConfig(**manifest["cfg"])

    # --------------------------------------------------------------- segments
    def new_segment_path(self) -> str:
        name = f"seg-{self._next_id:06d}.coco"
        self._next_id += 1
        return os.path.join(self.root, name)

    def write_tree(self, tree) -> str:
        """Persist a ``CoconutTree`` (on any device) as a fresh segment;
        returns its file name (relative to root).  NOT yet referenced by the manifest —
        commit separately."""
        path = self.new_segment_path()
        write_segment(path, tree, io=self.io)
        return os.path.basename(path)

    def open_segment(self, name: str) -> Segment:
        return Segment.open(os.path.join(self.root, name))

    def segment_files(self) -> List[str]:
        return sorted(f for f in os.listdir(self.root) if _SEG_RE.match(f))

    def live_files(self) -> List[str]:
        m = self.load_manifest()
        if m is None:
            return []
        return [r["file"] for r in m["runs"]]

    # --------------------------------------------------------------- recovery
    def recover(self) -> Dict[str, List[str]]:
        """Replay the commit protocol after a crash.

        * a leftover ``MANIFEST.json.tmp`` is an uncommitted commit —
          discarded (the committed manifest, if any, stays authoritative);
        * segment files not referenced by the manifest (orphans from a
          crash between steps 1-2 or 2-3) are deleted;
        * referenced segments must open cleanly (footer + header crc);
          a referenced-but-corrupt segment raises — that is data loss the
          caller must hear about, not silently drop.
        """
        report = {"removed": [], "kept": []}
        tmp = self.manifest_path + ".tmp"
        if os.path.exists(tmp):
            os.unlink(tmp)
            report["removed"].append(os.path.basename(tmp))
        live = set(self.live_files())
        for f in self.segment_files():
            if f not in live:
                os.unlink(os.path.join(self.root, f))
                report["removed"].append(f)
            else:
                seg = self.open_segment(f)   # raises SegmentFormatError
                seg.close()
                report["kept"].append(f)
        return report

    def gc(self) -> List[str]:
        """Delete finalized segments the manifest no longer references."""
        live = set(self.live_files())
        removed = []
        for f in self.segment_files():
            if f not in live:
                os.unlink(os.path.join(self.root, f))
                removed.append(f)
        return removed

    # --------------------------------------------------------------- lifetime
    def close(self) -> None:
        """Release the store.  Segments are opened per-operation and WAL
        handles are owned by the engine, so today this only marks the
        store closed for symmetry with ``CoconutLSM.close`` — examples and
        tests can rely on ``with SegmentStore(...) as store:`` shutting
        everything down deterministically."""

    def __enter__(self) -> "SegmentStore":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------ diagnostics
    def wal_bytes(self) -> int:
        """On-disk write-ahead-log footprint beside the segments."""
        from ..ingest.wal import WriteAheadLog
        return WriteAheadLog.wal_bytes(self.root)

    def total_bytes(self) -> int:
        return sum(os.path.getsize(os.path.join(self.root, f))
                   for f in self.segment_files())

    def describe(self) -> str:
        m = self.load_manifest()
        nruns = len(m["runs"]) if m else 0
        return (f"SegmentStore({self.root}: {len(self.segment_files())} "
                f"segments, {nruns} live runs, "
                f"{self.total_bytes() / 1e6:.2f} MB, "
                f"WAL {self.wal_bytes() / 1e3:.1f} kB)")


# ---------------------------------------------------------------------------
# Multi-shard namespace: one data dir, one atomic top-level manifest
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardDirectory:
    """One data directory holding N shard stores plus ``SHARDS.json``.

    Layout::

        root/
          SHARDS.json            <- the atomic top-level commit point
          shard-000-g0/          <- one full SegmentStore per shard
            MANIFEST.json  seg-*.coco  wal-*.log
          shard-001-g0/
          ...

    ``SHARDS.json`` records the shard count, the routing boundaries
    (z-order splitter keys), and which subdirectories are live.  It is
    committed with the same write-fsync-replace protocol as a per-shard
    manifest, so the *set of shards and their key ranges* changes
    atomically; each shard's contents stay crash-consistent through its
    own manifest + WAL.  Rebalancing migrations build a new generation of
    shard dirs, commit ``SHARDS.json`` pointing at them, then delete the
    old generation — :meth:`cleanup` removes dirs from either side of a
    crash (new-but-uncommitted, or old-but-superseded).
    """
    root: str
    io: Optional[IOStats] = None

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)

    @property
    def meta_path(self) -> str:
        return os.path.join(self.root, SHARDS_NAME)

    def exists(self) -> bool:
        return os.path.exists(self.meta_path)

    def load(self) -> Optional[dict]:
        if not self.exists():
            return None
        with open(self.meta_path) as f:
            meta = json.load(f)
        if meta.get("version") != SHARDS_VERSION:
            raise SegmentFormatError(
                f"{self.meta_path}: unknown shard-manifest version")
        return meta

    def commit(self, meta: dict) -> None:
        """Atomically publish shard count / boundaries / live dirs."""
        meta = dict(meta, version=SHARDS_VERSION)
        write_json_atomic(self.meta_path, meta)
        if self.io is not None:
            self.io.rand_write(1)

    @staticmethod
    def shard_dir_name(index: int, generation: int = 0) -> str:
        return f"shard-{index:03d}-g{generation}"

    def shard_store(self, name: str) -> SegmentStore:
        return SegmentStore(os.path.join(self.root, name), io=self.io)

    def shard_dirs_on_disk(self) -> List[str]:
        return sorted(d for d in os.listdir(self.root)
                      if _SHARD_DIR_RE.match(d)
                      and os.path.isdir(os.path.join(self.root, d)))

    def cleanup(self) -> List[str]:
        """Remove shard dirs the committed ``SHARDS.json`` doesn't
        reference — orphans of a crashed migration (either generation)
        — plus a torn ``SHARDS.json.tmp``.  Returns what was removed."""
        removed = []
        tmp = self.meta_path + ".tmp"
        if os.path.exists(tmp):
            os.unlink(tmp)
            removed.append(os.path.basename(tmp))
        meta = self.load()
        live = set(meta["dirs"]) if meta else set()
        for d in self.shard_dirs_on_disk():
            if d not in live:
                shutil.rmtree(os.path.join(self.root, d))
                removed.append(d)
        return removed

    def describe(self) -> str:
        meta = self.load()
        if meta is None:
            return f"ShardDirectory({self.root}: uncommitted)"
        stores = [self.shard_store(d) for d in meta["dirs"]]
        total = sum(s.total_bytes() for s in stores)
        wal = sum(s.wal_bytes() for s in stores)
        segs = sum(len(s.segment_files()) for s in stores)
        return (f"ShardDirectory({self.root}: {len(stores)} shards, "
                f"{segs} segments, {total / 1e6:.2f} MB, "
                f"WAL {wal / 1e3:.1f} kB)")
