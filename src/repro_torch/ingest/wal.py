"""Write-ahead log for raw series inserts: the durability half of ingest.

The segment store makes flushed runs durable, but everything still
sitting in the insert buffer would die with the process — the classic
no-WAL LSM gap.  This log closes it: every ``insert`` batch is appended
here as a checksummed record *before* it is acknowledged, so after a crash
``CoconutLSM.open`` replays the tail of the insert stream and recovers
every acked row, flushed or not.

Layout: ``wal-NNNNNN.log`` files beside the segment files.  Each file is

    +----------------------------------------------+
    | header (16 B): magic "COCOWAL1", version     |
    +----------------------------------------------+
    | record*: u32 crc32(payload), u32 len,        |
    |          payload = u64 start_row, u32 n,     |
    |          u32 L, u32 flags, raw f32[n*L],     |
    |          ts i64[n][, ids i64[n]]             |
    +----------------------------------------------+

``start_row`` is the record's absolute position in the insert stream
(total rows ever inserted before it).  Because the LSM consumes its buffer
strictly FIFO, the committed runs always cover a *prefix* of that stream;
the manifest records the prefix length as ``wal_start`` and replay simply
skips rows below it — a record may therefore be safely replayed twice.

Truncation happens by rotation, at manifest-commit time: a fresh
``wal-(seq+1).log`` holding only the not-yet-durable tail (the current
buffer) is written and fsynced, and only then are the older files deleted.
A crash anywhere leaves either the old files (still covering the tail) or
both (replay dedups by ``start_row``) — never neither.

fsync policy (``fsync=``):
  * ``"always"`` — fsync every append; an acked insert survives OS crash.
  * ``"commit"`` — fsync only at rotation/close; an acked insert survives
    *process* crash (data is in the page cache) but not power loss.
  * ``"never"``  — no fsync on append or close; rotation still fsyncs
    before deleting the files it replaces.

A torn record at the *tail* of the newest file is an interrupted append
(possibly never acked) and is discarded; a bad record anywhere else, or a
gap in ``start_row`` coverage, is real corruption and raises.

The record layout is the reference's byte for byte (the same header,
struct formats, crc32 and column order), so either package replays the
other's log.  A batch given as a tensor (on the card or the CPU) is
copied to the host before it is encoded.
"""
from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.metrics import IngestMetrics, IOStats
from ..storage.store import _fsync_dir   # one durability primitive, one home

__all__ = ["WriteAheadLog", "WALCorruptionError", "FSYNC_POLICIES"]

MAGIC = b"COCOWAL1"
HEADER_SIZE = 16
VERSION = 2
_WAL_RE = re.compile(r"^wal-(\d{6,})\.log$")
_REC_FMT = "<II"             # crc32(payload), payload length
_PAY_FMT = "<QIII"           # start_row, n, L, flags (v2)
_PAY_FMT_V1 = "<QII"         # start_row, n, L        (v1, read-only)
_PF_HAS_IDS = 1 << 0         # ids i64[n] trail the timestamps
FSYNC_POLICIES = ("always", "commit", "never")


def _host(a):
    """A batch column as a host array (a tensor is copied off its device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return a


class WALCorruptionError(RuntimeError):
    """A WAL record failed its checksum (not at the tail) or left a gap."""


def _wal_files(root: str) -> List[Tuple[int, str]]:
    """(seq, filename) for every WAL file in ``root``, oldest first."""
    out = [(int(m.group(1)), f) for f in os.listdir(root)
           if (m := _WAL_RE.match(f))]
    out.sort()
    return out


def _read_records(path: str, *, is_last_file: bool
                  ) -> Iterator[Tuple[int, np.ndarray, np.ndarray,
                                      Optional[np.ndarray]]]:
    """Yield (start_row, raw [n, L], ts [n], ids [n] | None) for every
    intact record.

    A short/corrupt record in the last file ends iteration (torn tail
    from an interrupted append); anywhere else it raises.  Version-1
    files (no ids) are still readable; their ids come back as None.
    """
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
        if len(head) < HEADER_SIZE or head[:8] != MAGIC:
            raise WALCorruptionError(f"{path}: bad WAL header")
        version, = struct.unpack_from("<I", head, 8)
        if version not in (1, VERSION):
            raise WALCorruptionError(f"{path}: unknown WAL version")
        pos = HEADER_SIZE
        rec_hdr = struct.calcsize(_REC_FMT)
        while pos < size:
            hdr = f.read(rec_hdr)
            payload = b""
            want = None
            if len(hdr) == rec_hdr:
                crc, want = struct.unpack(_REC_FMT, hdr)
                payload = f.read(want)
            if want is None or len(payload) < want \
                    or zlib.crc32(payload) != crc:
                if is_last_file:
                    return               # torn tail: interrupted append
                raise WALCorruptionError(
                    f"{path}: corrupt record at byte {pos}")
            if version == 1:
                start_row, n, L = struct.unpack_from(_PAY_FMT_V1, payload, 0)
                flags = 0
                body = payload[struct.calcsize(_PAY_FMT_V1):]
            else:
                start_row, n, L, flags = struct.unpack_from(_PAY_FMT,
                                                            payload, 0)
                body = payload[struct.calcsize(_PAY_FMT):]
            raw_bytes = 4 * n * L
            ids_bytes = 8 * n if flags & _PF_HAS_IDS else 0
            if len(body) != raw_bytes + 8 * n + ids_bytes:
                raise WALCorruptionError(
                    f"{path}: record at byte {pos} has inconsistent size")
            raw = np.frombuffer(body[:raw_bytes],
                                np.float32).reshape(n, L).copy()
            ts = np.frombuffer(body[raw_bytes: raw_bytes + 8 * n],
                               np.int64).copy()
            ids = (np.frombuffer(body[raw_bytes + 8 * n:], np.int64).copy()
                   if ids_bytes else None)
            yield start_row, raw, ts, ids
            pos += rec_hdr + want


class WriteAheadLog:
    """Appender side of the log.  One active file; rotation supersedes it."""

    def __init__(self, root: str, *, fsync: str = "always",
                 io: Optional[IOStats] = None,
                 metrics: Optional[IngestMetrics] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync must be one of {FSYNC_POLICIES}, got {fsync!r}")
        self.root = root
        self.fsync = fsync
        self.io = io
        self.metrics = metrics
        existing = _wal_files(root)
        self._seq = (existing[-1][0] if existing else 0) + 1
        self._f = None
        self._live_bytes = 0
        self._open_active()

    # ------------------------------------------------------------------ files
    def _path(self, seq: int) -> str:
        return os.path.join(self.root, f"wal-{seq:06d}.log")

    @property
    def active_path(self) -> str:
        return self._path(self._seq)

    def _open_active(self) -> None:
        self._f = open(self.active_path, "wb")
        self._f.write(MAGIC + struct.pack("<I", VERSION)
                      + b"\0" * (HEADER_SIZE - 12))
        self._f.flush()
        if self.fsync != "never":
            # the directory entry must be durable too, or a power loss
            # can make every fsynced record vanish with its file
            os.fsync(self._f.fileno())
            _fsync_dir(self.root)
        self._live_bytes = HEADER_SIZE

    # ----------------------------------------------------------------- append
    @staticmethod
    def _encode(start_row: int, raw: np.ndarray, ts: np.ndarray,
                ids: Optional[np.ndarray] = None) -> bytes:
        raw = np.ascontiguousarray(_host(raw), np.float32)
        ts = np.ascontiguousarray(_host(ts), np.int64)
        n, L = raw.shape
        flags = 0
        tail = b""
        if ids is not None:
            flags |= _PF_HAS_IDS
            tail = np.ascontiguousarray(_host(ids), np.int64).tobytes()
        payload = (struct.pack(_PAY_FMT, start_row, n, L, flags)
                   + raw.tobytes() + ts.tobytes() + tail)
        return struct.pack(_REC_FMT, zlib.crc32(payload),
                           len(payload)) + payload

    def append(self, raw: np.ndarray, ts: np.ndarray,
               start_row: int, ids: Optional[np.ndarray] = None) -> int:
        """Log one insert batch; returns bytes written.  With
        ``fsync="always"`` the record is on stable storage on return —
        the caller may then ack the insert.  ``ids`` (global row ids) are
        logged alongside so replay restores exactly the ids the batch was
        acked with — the sharded router's ids are not reconstructible
        from the shard-local stream."""
        rec = self._encode(start_row, raw, ts, ids)
        self._f.write(rec)
        self._f.flush()
        if self.fsync == "always":
            os.fsync(self._f.fileno())
        self._live_bytes += len(rec)
        if self.io is not None:
            self.io.write_bytes(len(rec))
            self.io.seq_write(len(raw))
        if self.metrics is not None:
            self.metrics.add("wal_appends")
            self.metrics.add("wal_bytes", len(rec))
            self.metrics.set_gauge("wal_live_bytes", self._live_bytes)
        return len(rec)

    # --------------------------------------------------------------- rotation
    def rotate(self, tail: List[Tuple[int, np.ndarray, np.ndarray,
                                      Optional[np.ndarray]]]) -> None:
        """Supersede every existing WAL file with a fresh one holding only
        ``tail`` — the (start_row, raw, ts, ids) batches not yet covered by
        the committed manifest.  Called *after* the manifest commit, so a
        crash at any point leaves a replayable log.  The new file is always
        fsynced before the old ones are deleted, regardless of policy."""
        old = [f for _, f in _wal_files(self.root)]
        self._f.close()
        self._seq += 1
        self._open_active()
        for start_row, raw, ts, ids in tail:
            rec = self._encode(start_row, raw, ts, ids)
            self._f.write(rec)
            self._live_bytes += len(rec)
        self._f.flush()
        os.fsync(self._f.fileno())
        _fsync_dir(self.root)    # new file durable BEFORE the old ones go
        for f in old:
            os.unlink(os.path.join(self.root, f))
        _fsync_dir(self.root)
        if self.metrics is not None:
            self.metrics.add("wal_rotations")
            self.metrics.set_gauge("wal_live_bytes", self._live_bytes)

    def close(self) -> None:
        if self._f is None or self._f.closed:
            return
        self._f.flush()
        if self.fsync != "never":
            os.fsync(self._f.fileno())
        self._f.close()

    # ----------------------------------------------------------------- replay
    @staticmethod
    def replay(root: str, start_row: int
               ) -> List[Tuple[np.ndarray, np.ndarray,
                               Optional[np.ndarray]]]:
        """Recover every logged (raw, ts, ids) batch from ``start_row`` on.

        Walks the WAL files oldest-first, slicing each record to the rows
        not yet consumed (rotation leaves overlapping coverage on purpose;
        content for a given absolute row is identical in every copy).  A
        gap in coverage raises — acked rows would otherwise silently
        vanish.  ``ids`` is None for records logged without ids (v1 files).
        """
        files = _wal_files(root)
        out: List[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]] = []
        nxt = start_row
        for i, (_, name) in enumerate(files):
            path = os.path.join(root, name)
            last = i == len(files) - 1
            for s, raw, ts, ids in _read_records(path, is_last_file=last):
                n = len(raw)
                if s + n <= nxt:
                    continue             # fully consumed by committed runs
                if s > nxt:
                    raise WALCorruptionError(
                        f"{path}: gap in WAL coverage — have rows up to "
                        f"{nxt}, next record starts at {s}")
                lo = nxt - s
                out.append((raw[lo:], ts[lo:],
                            None if ids is None else ids[lo:]))
                nxt = s + n
        return out

    @staticmethod
    def wal_bytes(root: str) -> int:
        """Total on-disk WAL footprint (diagnostics)."""
        return sum(os.path.getsize(os.path.join(root, f))
                   for _, f in _wal_files(root))
