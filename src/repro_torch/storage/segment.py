"""On-disk Coconut segment: one sorted run as a contiguous binary file.

The paper's central storage claim (Sec. 4.3, and the sequential-write
analysis of arXiv 2006.13713) is that sortable summarizations let the whole
index live in a *contiguous on-disk array* written with large sequential
appends — no tree of scattered pages.  A segment file is exactly that
array, laid out column-major so each query touches only the columns it
needs:

    +--------------------------------------------------------------+
    | header (512 B): magic, crc, flags, n, SummaryConfig, layout  |
    +--------------------------------------------------------------+
    | codes       [N, ceil(w*b/8)] uint8  bit-packed SAX words     |
    | paas        [N, w]       float32  PAA values (sorted order)  |
    | offsets     [N]          int64    position in original file  |
    | timestamps  [N]          int64    (optional)                 |
    | raw         [N, L]       float32  (optional; co-sorted when  |
    |                                    materialized, original    |
    |                                    order otherwise)          |
    | fences      [ceil(N/leaf), n_words] uint32  leaf-first keys  |
    | ids         [N]          int64    global row ids (optional)  |
    | keys        <variable>   delta+zigzag-varint encoded, with a |
    |                          per-leaf byte directory (format v3) |
    +--------------------------------------------------------------+
    | footer (20 B): magic, n, header-crc echo                     |
    +--------------------------------------------------------------+

**Format v3** (current): the codes column is bit-packed to ``cfg.bits``
bits per symbol and the sorted keys column is delta+varint encoded per
leaf (see :mod:`repro_torch.storage.packing`) — Coconut's storage-cost claim
made real on disk and in the tiered leaf cache.  Versions 1/2 (full-byte
codes, fixed-width keys placed first in the column chain) remain fully
readable: :meth:`Segment.open` detects the version and the ``keys`` /
``codes`` properties present the same decoded view either way, so every
consumer — and every search answer — is version-agnostic.

Every column is 64-byte aligned and carries a crc32.  The header embeds
the ``SummaryConfig`` so a segment is self-describing; the footer is
written *last*, so a file without a valid footer is an interrupted write
and is discarded during recovery by the store that owns it.

Reading is zero-copy for the fixed columns: :class:`Segment` exposes each
as an ``np.memmap`` (packed columns behind thin decoding views), and
:func:`exact_search_mmap` streams the surviving leaves' code rows through
the ``unpack_mindist`` kernel, charging the *actual* bytes touched to
:class:`repro_torch.core.metrics.IOStats`.

The file format is the reference package's byte for byte: a segment
written by either package opens bit-identically in the other.  On disk
the key words are uint32; a tree loaded with :meth:`Segment.to_tree`
holds them as int64 words in ``[0, 2**32)`` on its device (the card
unless ``device="cpu"``).  Rows are read on the host from the mmap and
copied to the device explicitly (fancy indexing and slice copies give
writable host arrays; the read-only mapping is never written through).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..core import summarization as S
from ..core.metrics import IOStats
from .packing import (PackedCodes, PackedKeys, encode_keys, pack_codes,
                      packed_code_width)

__all__ = ["Segment", "SegmentWriter", "write_segment",
           "exact_search_mmap", "SegmentFormatError",
           "MAGIC", "FOOTER_MAGIC", "HEADER_SIZE", "FOOTER_SIZE",
           "VERSION", "LEGACY_VERSIONS"]

MAGIC = b"COCOSEG1"
FOOTER_MAGIC = b"COCOFIN1"
HEADER_SIZE = 512
FOOTER_SIZE = 20
_ALIGN = 64
VERSION = 3                 # packed codes + delta/varint keys
LEGACY_VERSIONS = (1, 2)    # full-byte codes, fixed-width keys

# flags
F_MATERIALIZED = 1 << 0    # raw block is co-sorted with the keys
F_HAS_TS = 1 << 1          # timestamps column present
F_HAS_RAW = 1 << 2         # raw block present
F_HAS_IDS = 1 << 3         # global row ids column present

# "ids" appended LAST so the positional column table of pre-ids files
# still parses: their header's 8th entry reads as zero padding (0, 0, 0),
# which matches the absent-column layout when F_HAS_IDS is clear.
_COLUMNS = ("keys", "codes", "paas", "offsets", "timestamps", "raw",
            "fences", "ids")
_DTYPES = {
    "keys": np.uint32, "codes": np.uint8, "paas": np.float32,
    "offsets": np.int64, "timestamps": np.int64, "raw": np.float32,
    "fences": np.uint32, "ids": np.int64,
}

# header: magic, crc, version, flags, n, L, w, b, leaf, n_words, n_fences
_HEAD_FMT = "<8sIHHQIIIIII"
_COL_FMT = "<QQI"          # per column: offset, nbytes, crc32
_FOOT_FMT = "<8sQI"        # magic, n, header-crc echo


class SegmentFormatError(RuntimeError):
    """Raised when a segment file is missing, truncated, or corrupt."""


def _align(off: int) -> int:
    return -(-off // _ALIGN) * _ALIGN


def _layout(n: int, cfg: S.SummaryConfig, leaf_size: int,
            has_ts: bool, has_raw: bool, has_ids: bool = False,
            version: int = VERSION) -> dict:
    """Column name -> (offset, nbytes, shape).  Deterministic given the
    header fields, so the writer can place columns before any data exists.

    Format v3 places the variable-length keys blob *after* the fixed
    columns: its entry carries ``(None, None, shape)`` here and the real
    ``(offset, nbytes)`` lives in the header's column table (written at
    finalize, once the encoded size is known).  ``__var__`` marks where
    that blob starts; for legacy versions the keys column sits first in
    the fixed chain exactly as v1 wrote it.
    """
    w, nw, L = cfg.segments, cfg.n_words, cfg.series_len
    n_fences = -(-n // leaf_size) if n else 0
    code_w = packed_code_width(w, cfg.bits) if version >= 3 else w
    shapes = {
        "keys": (n, nw), "codes": (n, code_w), "paas": (n, w),
        "offsets": (n,), "timestamps": (n,) if has_ts else None,
        "raw": (n, L) if has_raw else None,
        "fences": (n_fences, nw),
        "ids": (n,) if has_ids else None,
    }
    out, off = {}, HEADER_SIZE
    for name in _COLUMNS:
        shape = shapes[name]
        if shape is None:
            out[name] = (0, 0, None)
            continue
        if name == "keys" and version >= 3:
            out[name] = (None, None, shape)
            continue
        nbytes = int(np.prod(shape, dtype=np.int64)) * \
            np.dtype(_DTYPES[name]).itemsize
        off = _align(off)
        out[name] = (off, nbytes, shape)
        off += nbytes
    out["__var__"] = (_align(off), 0, None)
    # v3's footer lands after the keys blob — position resolved at
    # finalize (writer) / from the header's keys entry (reader)
    out["__footer__"] = ((None if version >= 3 else _align(off)),
                         FOOTER_SIZE, None)
    return out


class SegmentWriter:
    """Streaming segment writer: large sequential appends per column.

    ``n`` (the total entry count) must be known up front — exactly what the
    external-sort build provides after its chunking pass — so every column
    region has a fixed place and each region is filled strictly
    sequentially.  The header is written twice: a zeroed placeholder first
    (an interrupted write is therefore unreadable), the real one at
    :meth:`finalize` after the footer, then fsync.

    Writes format v3 by default (packed codes, delta/varint keys);
    ``version=1`` reproduces the legacy full-byte layout byte for byte
    (migration tests build old-format fixtures through it).  ``append``
    accepts codes either full-width ``[m, w]`` (packed here) or already
    packed ``[m, ceil(w*b/8)]`` (copied verbatim — the external-sort merge
    path, which never needs the decoded bytes).
    """

    def __init__(self, path: str, cfg: S.SummaryConfig, n: int, *,
                 leaf_size: int = 256, materialized: bool = True,
                 has_timestamps: bool = False, has_raw: bool = True,
                 has_ids: bool = False,
                 io: Optional[IOStats] = None,
                 version: int = VERSION):
        if materialized and not has_raw:
            raise ValueError("materialized segment requires the raw block")
        if version != VERSION and version not in LEGACY_VERSIONS:
            raise ValueError(f"unwritable segment version {version}")
        self.path = path
        self.cfg = cfg
        self.n = int(n)
        self.leaf_size = int(leaf_size)
        self.materialized = bool(materialized)
        self.has_ts = bool(has_timestamps)
        self.has_raw = bool(has_raw)
        self.has_ids = bool(has_ids)
        self.io = io
        self.version = int(version)
        self._layout = _layout(self.n, cfg, self.leaf_size,
                               self.has_ts, self.has_raw, self.has_ids,
                               version=self.version)
        self._pos = {name: 0 for name in _COLUMNS}   # rows written per col
        self._crc = {name: 0 for name in _COLUMNS}
        self._fences: list[np.ndarray] = []
        self._key_parts: list[np.ndarray] = []       # v3: buffered keys
        self._f = open(path, "w+b")
        self._f.write(b"\0" * HEADER_SIZE)

    # ------------------------------------------------------------------ write
    def _put(self, name: str, arr: np.ndarray) -> None:
        off, nbytes, shape = self._layout[name]
        if shape is None:
            raise ValueError(f"segment has no {name!r} column")
        arr = np.ascontiguousarray(arr, dtype=_DTYPES[name])
        want = shape[1:] if len(shape) > 1 else ()
        if arr.shape[1:] != want:
            raise ValueError(f"{name}: row shape {arr.shape[1:]} != {want}")
        row_bytes = arr.dtype.itemsize * int(np.prod(want, dtype=np.int64)
                                             or 1)
        start = self._pos[name]
        if start + len(arr) > self.n:
            raise ValueError(f"{name}: {start + len(arr)} rows > n={self.n}")
        buf = arr.tobytes()
        self._f.seek(off + start * row_bytes)
        self._f.write(buf)
        self._crc[name] = zlib.crc32(buf, self._crc[name])
        self._pos[name] = start + len(arr)
        if self.io is not None:
            self.io.write_bytes(len(buf))
            self.io.seq_write(len(arr))

    def _put_codes(self, codes: np.ndarray) -> None:
        """Route codes through the packer when the target layout packs."""
        codes = np.asarray(codes)
        if self.version >= 3:
            w = self.cfg.segments
            pw = packed_code_width(w, self.cfg.bits)
            if codes.ndim == 2 and codes.shape[1] == w and pw != w:
                codes = pack_codes(codes, self.cfg.bits)
        self._put("codes", codes)

    def append(self, keys: np.ndarray, codes: np.ndarray, paas: np.ndarray,
               offsets: np.ndarray,
               timestamps: Optional[np.ndarray] = None,
               raw: Optional[np.ndarray] = None,
               ids: Optional[np.ndarray] = None) -> None:
        """Append a batch of *sorted-order* rows to every sorted column.

        ``raw`` is required (and co-sorted) iff the segment is
        materialized; for non-materialized segments the original-order raw
        block is streamed separately via :meth:`append_raw`.
        """
        keys = np.ascontiguousarray(keys, np.uint32)
        start = self._pos["keys"]
        if self.version >= 3:
            if start + len(keys) > self.n:
                raise ValueError(
                    f"keys: {start + len(keys)} rows > n={self.n}")
            self._key_parts.append(keys)
            self._pos["keys"] = start + len(keys)
        else:
            self._put("keys", keys)
        self._put_codes(codes)
        self._put("paas", paas)
        self._put("offsets", offsets)
        if self.has_ts:
            if timestamps is None:
                raise ValueError("segment expects timestamps")
            self._put("timestamps", timestamps)
        if self.has_ids:
            if ids is None:
                raise ValueError("segment expects global row ids")
            self._put("ids", ids)
        if self.materialized:
            if raw is None:
                raise ValueError("materialized segment expects raw rows")
            self._put("raw", raw)
        # collect leaf-first keys (every leaf_size-th global row) as fences
        idx = np.arange(start, start + len(keys))
        mask = idx % self.leaf_size == 0
        if mask.any():
            self._fences.append(keys[mask])

    def append_raw(self, rows: np.ndarray) -> None:
        """Append original-order raw rows (non-materialized segments)."""
        if self.materialized:
            raise ValueError("materialized raw is appended via append()")
        self._put("raw", rows)

    # --------------------------------------------------------------- finalize
    def finalize(self) -> None:
        for name in _COLUMNS:
            off, nbytes, shape = self._layout[name]
            if name == "fences" or shape is None:
                continue
            want = shape[0]
            if self._pos[name] != want:
                raise ValueError(
                    f"{name}: wrote {self._pos[name]} rows, expected {want}")
        fences = (np.concatenate(self._fences) if self._fences
                  else np.zeros((0, self.cfg.n_words), np.uint32))
        self._put("fences", fences)
        if self.version >= 3:
            keys = (np.concatenate(self._key_parts) if self._key_parts
                    else np.zeros((0, self.cfg.n_words), np.uint32))
            blob = encode_keys(keys, self.leaf_size)
            buf = blob.tobytes()
            var_off = self._layout["__var__"][0]
            self._f.seek(var_off)
            self._f.write(buf)
            self._crc["keys"] = zlib.crc32(buf)
            self._layout["keys"] = (var_off, len(buf),
                                    self._layout["keys"][2])
            self._layout["__footer__"] = (_align(var_off + len(buf)),
                                          FOOTER_SIZE, None)
            if self.io is not None:
                self.io.write_bytes(len(buf))
                self.io.seq_write(len(keys))
        header = self._header_bytes()
        head_crc, = struct.unpack_from("<I", header, 8)
        foot_off = self._layout["__footer__"][0]
        self._f.seek(foot_off)
        self._f.write(struct.pack(_FOOT_FMT, FOOTER_MAGIC, self.n,
                                  head_crc))
        self._f.seek(0)
        self._f.write(header)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        if self.io is not None:
            self.io.write_bytes(HEADER_SIZE + FOOTER_SIZE)

    def abort(self) -> None:
        self._f.close()
        if os.path.exists(self.path):
            os.unlink(self.path)

    def _header_bytes(self) -> bytes:
        flags = ((F_MATERIALIZED if self.materialized else 0)
                 | (F_HAS_TS if self.has_ts else 0)
                 | (F_HAS_RAW if self.has_raw else 0)
                 | (F_HAS_IDS if self.has_ids else 0))
        n_fences = self._layout["fences"][2][0]
        head = bytearray(HEADER_SIZE)
        struct.pack_into(_HEAD_FMT, head, 0, MAGIC, 0, self.version, flags,
                         self.n, self.cfg.series_len, self.cfg.segments,
                         self.cfg.bits, self.leaf_size, self.cfg.n_words,
                         n_fences)
        pos = struct.calcsize(_HEAD_FMT)
        for name in _COLUMNS:
            off, nbytes, shape = self._layout[name]
            struct.pack_into(_COL_FMT, head, pos,
                             off if shape is not None else 0, nbytes,
                             self._crc[name])
            pos += struct.calcsize(_COL_FMT)
        crc = zlib.crc32(bytes(head[12:]))
        struct.pack_into("<I", head, 8, crc)
        return bytes(head)


def _host(t) -> Optional[np.ndarray]:
    """A tree column (tensor on any device) as a host array."""
    return None if t is None else t.detach().cpu().numpy()


def write_segment(path: str, tree, *, io: Optional[IOStats] = None,
                  version: int = VERSION) -> None:
    """Persist an in-memory ``CoconutTree`` as one segment file.

    One large sequential write per column — the O(N/B) sequential-write
    cost of the paper's bulk load, now against a real file.  The columns
    are cast to the on-disk types (uint32 key words, int64 offsets).
    """
    has_ts = tree.timestamps is not None
    has_raw = tree.raw is not None or tree.raw_ref is not None
    has_ids = tree.ids is not None
    w = SegmentWriter(path, tree.cfg, tree.n, leaf_size=tree.leaf_size,
                      materialized=tree.materialized,
                      has_timestamps=has_ts, has_raw=has_raw,
                      has_ids=has_ids, io=io, version=version)
    try:
        w.append(_host(tree.keys), _host(tree.codes), _host(tree.paas),
                 _host(tree.offsets), timestamps=_host(tree.timestamps),
                 raw=_host(tree.raw) if tree.materialized else None,
                 ids=_host(tree.ids))
        if has_raw and not tree.materialized:
            w.append_raw(_host(tree.raw_ref))
        w.finalize()
    except BaseException:
        w.abort()
        raise


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def take_rows(col, idx: np.ndarray) -> np.ndarray:
    """``col[idx]`` as a fresh host array: one slice copy when ``idx`` is a
    single ascending run (a leaf group, a seed window), else a fancy-index
    gather (which copies too)."""
    idx = np.asarray(idx)
    if len(idx) and (len(idx) == 1 or (idx[-1] - idx[0] == len(idx) - 1
                                       and bool(np.all(np.diff(idx) == 1)))):
        return np.array(col[int(idx[0]):int(idx[-1]) + 1])
    return np.asarray(col[idx])


def _to_device(col, dtype: torch.dtype, dev: torch.device,
               rows: int = 1 << 16) -> torch.Tensor:
    """A (memmapped or decoding) column as a tensor on ``dev``, copied in
    blocks of ``rows`` so host memory holds one block at a time."""
    out = torch.empty(tuple(col.shape), dtype=dtype, device=dev)
    for s in range(0, len(col), rows):
        blk = np.array(col[s:s + rows])
        out[s:s + len(blk)] = torch.from_numpy(blk).to(dtype)
    return out


@dataclasses.dataclass
class Segment:
    """mmap-backed view of one segment file (open with :meth:`open`)."""
    path: str
    cfg: S.SummaryConfig
    n: int
    leaf_size: int
    materialized: bool
    columns: dict                    # name -> np.memmap (or None)
    column_crcs: dict                # name -> stored crc32
    nbytes: int                      # file size on disk
    version: int = VERSION
    _keys_view: Optional[PackedKeys] = dataclasses.field(
        default=None, repr=False, compare=False)
    _codes_view: Optional[PackedCodes] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def open(cls, path: str) -> "Segment":
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                head = f.read(HEADER_SIZE)
        except OSError as e:
            raise SegmentFormatError(f"{path}: {e}") from e
        if len(head) < HEADER_SIZE:
            raise SegmentFormatError(f"{path}: truncated header")
        (magic, crc, version, flags, n, L, w, b, leaf, nw,
         n_fences) = struct.unpack_from(_HEAD_FMT, head, 0)
        if magic != MAGIC:
            raise SegmentFormatError(f"{path}: bad magic {magic!r}")
        if zlib.crc32(head[12:]) != crc:
            raise SegmentFormatError(f"{path}: header checksum mismatch")
        if version != VERSION and version not in LEGACY_VERSIONS:
            raise SegmentFormatError(f"{path}: unknown version {version}")
        cfg = S.SummaryConfig(series_len=L, segments=w, bits=b)
        if cfg.n_words != nw:
            raise SegmentFormatError(f"{path}: n_words {nw} inconsistent")
        pos = struct.calcsize(_HEAD_FMT)
        cols, crcs = {}, {}
        lay = _layout(n, cfg, leaf,
                      bool(flags & F_HAS_TS), bool(flags & F_HAS_RAW),
                      bool(flags & F_HAS_IDS), version=version)
        keys_end = 0
        for name in _COLUMNS:
            off, nbytes, col_crc = struct.unpack_from(_COL_FMT, head, pos)
            pos += struct.calcsize(_COL_FMT)
            want_off, want_bytes, shape = lay[name]
            if shape is None:
                if nbytes:
                    raise SegmentFormatError(
                        f"{path}: unexpected {name} column")
                cols[name] = None
                continue
            if name == "keys" and version >= 3:
                # variable-length blob: the header's (offset, nbytes) is
                # authoritative, anchored at the deterministic var start
                if off != lay["__var__"][0] or off + nbytes > size:
                    raise SegmentFormatError(
                        f"{path}: keys layout mismatch")
                crcs[name] = col_crc
                cols[name] = (np.memmap(path, dtype=np.uint8, mode="r",
                                        offset=off, shape=(nbytes,))
                              if nbytes else np.zeros(0, np.uint8))
                keys_end = off + nbytes
                continue
            if (off, nbytes) != (want_off, want_bytes):
                raise SegmentFormatError(
                    f"{path}: {name} layout mismatch")
            if off + nbytes > size:
                raise SegmentFormatError(f"{path}: {name} beyond EOF")
            crcs[name] = col_crc
            if nbytes == 0:
                cols[name] = np.zeros(shape, _DTYPES[name])
            else:
                cols[name] = np.memmap(path, dtype=_DTYPES[name],
                                       mode="r", offset=off, shape=shape)
        foot_off = (_align(keys_end) if version >= 3
                    else lay["__footer__"][0])
        if foot_off + FOOTER_SIZE > size:
            raise SegmentFormatError(f"{path}: missing footer "
                                     "(interrupted write)")
        with open(path, "rb") as f:
            f.seek(foot_off)
            foot = f.read(FOOTER_SIZE)
        fmagic, fn, fcrc = struct.unpack(_FOOT_FMT, foot)
        if fmagic != FOOTER_MAGIC or fn != n or fcrc != crc:
            raise SegmentFormatError(f"{path}: bad footer "
                                     "(interrupted write)")
        seg = cls(path=path, cfg=cfg, n=n, leaf_size=leaf,
                  materialized=bool(flags & F_MATERIALIZED),
                  columns=cols, column_crcs=crcs, nbytes=size,
                  version=version)
        if version >= 3:
            seg._keys_view = PackedKeys(cols["keys"], n, nw, leaf)
            seg._codes_view = PackedCodes(cols["codes"], w, b)
        return seg

    # ------------------------------------------------------------ column views
    @property
    def keys(self):
        """Decoded ``[N, n_words]`` uint32 view (indexable like a memmap;
        v3 decodes leaf-at-a-time through :class:`PackedKeys`)."""
        return self._keys_view if self.version >= 3 else \
            self.columns["keys"]

    @property
    def codes(self):
        """Decoded ``[N, w]`` uint8 view (v3 unpacks on access)."""
        return self._codes_view if self.version >= 3 else \
            self.columns["codes"]

    @property
    def codes_packed(self) -> Optional[np.ndarray]:
        """Raw packed code storage ``[N, ceil(w*b/8)]`` (None on legacy
        files) — the zero-decode input of the fused unpack+mindist kernel
        and the block the leaf cache keeps resident."""
        return self.columns["codes"] if self.version >= 3 else None

    @property
    def code_row_bytes(self) -> int:
        """Stored bytes per code row (what a code read actually costs)."""
        return (packed_code_width(self.cfg.segments, self.cfg.bits)
                if self.version >= 3 else self.cfg.segments)

    def keys_leaf_nbytes(self, li: int) -> int:
        """Stored bytes of one leaf of the keys column."""
        if self.version >= 3:
            return self._keys_view.leaf_nbytes(li)
        s = li * self.leaf_size
        e = min(s + self.leaf_size, self.n)
        return (e - s) * self.cfg.n_words * 4

    @property
    def paas(self) -> np.memmap:
        return self.columns["paas"]

    @property
    def offsets(self) -> np.memmap:
        return self.columns["offsets"]

    @property
    def timestamps(self) -> Optional[np.memmap]:
        return self.columns["timestamps"]

    @property
    def raw(self) -> Optional[np.memmap]:
        return self.columns["raw"]

    @property
    def ids(self) -> Optional[np.memmap]:
        return self.columns["ids"]

    @property
    def fences(self) -> np.memmap:
        return self.columns["fences"]

    def verify(self) -> None:
        """Full-content check: recompute every column crc32 (reads all)."""
        for name, mm in self.columns.items():
            if mm is None or not isinstance(mm, np.memmap):
                continue
            got = zlib.crc32(mm.tobytes())
            if got != self.column_crcs[name]:
                raise SegmentFormatError(
                    f"{self.path}: {name} checksum mismatch")

    def series_rows(self, sorted_idx: np.ndarray,
                    io: Optional[IOStats] = None) -> np.ndarray:
        """Raw rows for sorted-order indices (handles both raw layouts),
        as a fresh host array."""
        if self.raw is None:
            raise SegmentFormatError(f"{self.path}: no raw block on disk")
        if self.materialized:
            rows = take_rows(self.raw, sorted_idx)
        else:
            rows = np.asarray(self.raw[take_rows(self.offsets, sorted_idx)])
        if io is not None:
            io.read_bytes(rows.nbytes)
        return rows

    def to_tree(self, device=None):
        """Load the segment into a ``CoconutTree`` on ``device`` (the card
        unless ``device="cpu"``; without CUDA and no explicit CPU request
        this raises).

        The columns are already sorted on disk, so this is a straight
        sequential read — no re-sorting — and searches on the result are
        bit-identical to the tree that produced the segment (packed
        columns decode exactly; pack/unpack is the identity round trip).
        Key words become int64 in ``[0, 2**32)``, offsets int64.
        """
        from ..core.tree import CoconutTree, _device_for
        dev = _device_for(None, device)
        raw = raw_ref = None
        if self.raw is not None:
            block = _to_device(self.raw, torch.float32, dev)
            raw, raw_ref = ((block, None) if self.materialized
                            else (None, block))

        def opt(col):
            return None if col is None else _to_device(col, torch.int64, dev)
        return CoconutTree(
            keys=_to_device(self.keys, torch.int64, dev),
            codes=_to_device(self.codes, torch.uint8, dev),
            paas=_to_device(self.paas, torch.float32, dev),
            offsets=_to_device(self.offsets, torch.int64, dev),
            raw=raw, raw_ref=raw_ref, timestamps=opt(self.timestamps),
            ids=opt(self.ids), cfg=self.cfg, leaf_size=self.leaf_size)

    def iter_sorted(self, batch: int = 8192
                    ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield (keys, codes, paas, offsets[, ts][, raw]) batches in key
        order — the sequential-read side of a k-way merge.

        On v3 files the codes element is the *packed* ``[m, ceil(w*b/8)]``
        uint8 rows, never a full-width decode: each packed row is
        independently byte-aligned, so the merge can copy rows verbatim
        into a new segment (``SegmentWriter.append`` accepts packed rows)
        and the round trip stays bit-exact with zero decode work.
        """
        codes_src = (self.columns["codes"] if self.version >= 3
                     else self.codes)
        for s in range(0, self.n, batch):
            e = min(s + batch, self.n)
            out = [np.asarray(self.keys[s:e]), np.asarray(codes_src[s:e]),
                   np.asarray(self.paas[s:e]),
                   np.asarray(self.offsets[s:e])]
            out.append(None if self.timestamps is None
                       else np.asarray(self.timestamps[s:e]))
            out.append(None if (self.raw is None or not self.materialized)
                       else np.asarray(self.raw[s:e]))
            yield tuple(out)

    def close(self) -> None:
        self._keys_view = None
        self._codes_view = None
        for name, mm in list(self.columns.items()):
            if isinstance(mm, np.memmap):
                del mm
            self.columns[name] = None


# ---------------------------------------------------------------------------
# Zero-copy query path: chunk-wise SIMS over the mmap'd columns
# ---------------------------------------------------------------------------

def exact_search_mmap(seg: Segment, queries, *,
                      k: int = 1, chunk: int = 8192,
                      radius_leaves: int = 1,
                      io: Optional[IOStats] = None,
                      mindist_fn=None,
                      budget=None,
                      mode: str = "exact",
                      device=None,
                      ) -> Tuple[np.ndarray, np.ndarray, "object"]:
    """Exact k-NN straight off the segment file (SIMS, Algorithm 5).

    The segment is just another backend of the unified query pipeline
    (:mod:`repro_torch.query`): the on-disk fence column prices every
    leaf with its z-order envelope mindist, the executor streams ONLY the
    surviving leaves' code rows from the mmap (skip-sequential — pruned
    leaves' pages are never touched), and unpruned rows are fetched from
    the raw block for verification.  Every byte that actually crosses the
    storage boundary is charged to ``io`` (``bytes_read``).  The seed,
    bound and verification kernels run on ``device`` (the card unless
    ``device="cpu"``); a v3 file's code rows reach ``unpack_mindist`` in
    their packed form.

    ``budget`` / ``mode="approx"`` come with the port of the reference's
    ``query/approx.py`` and raise :class:`NotImplementedError` until then.

    Returns ``(dists [Q, k], offsets [Q, k], SearchStats)`` — answers
    bit-identical to :func:`repro_torch.core.tree.exact_search_batch` on
    the same data.
    """
    from ..core.tree import _LATER
    from ..query import Partition, exact_knn
    if seg.raw is None:
        raise SegmentFormatError(
            f"{seg.path}: exact search needs the raw block on disk")
    if mode not in ("exact", "approx"):
        raise ValueError(f"mode must be 'exact' or 'approx', got {mode!r}")
    if budget is not None or mode == "approx":
        raise NotImplementedError(_LATER)
    return exact_knn([Partition.from_segment(seg, device=device)], queries,
                     seg.cfg, k=k, radius_leaves=radius_leaves, chunk=chunk,
                     io=io, mindist_fn=mindist_fn)
