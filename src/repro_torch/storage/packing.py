"""Compressed column codecs for segment format v3 (numpy; byte-identical
to the reference package's codecs, so either package reads the other's
files).

Coconut's storage pitch is that sortable summarizations shrink the index,
yet format v1/v2 spent a full byte per SAX symbol and 4 bytes per key
word regardless of ``cfg.bits``.  This module holds the two codecs the
v3 segment layout (and the tiered leaf cache built on top of it) uses to
make every byte of disk — and every byte of cache budget — hold more
leaves:

* **bit-packed codes** — each SAX word of ``w`` symbols at ``b`` bits is
  packed MSB-first into ``ceil(w*b/8)`` bytes.  Rows are packed
  *independently* (each row starts byte-aligned), so a leaf of packed
  rows is a plain contiguous slice and random leaf access needs no
  decoding context.  ``b == 8`` degenerates to the identity layout.

* **delta + zigzag-varint keys** — the sorted z-order key column is
  encoded per leaf: the leaf's first row is stored raw (``n_words``
  uint32 LE), every following row stores the per-word int64 delta from
  its predecessor as a zigzag LEB128 varint.  Sorted neighbours share
  their high words, so deltas are tiny.  Leaves decode independently
  through a byte-offset directory at the head of the column, matching
  the leaf-granular access pattern of the query pipeline and the cache.

Both codecs are exact (``decode(encode(x)) == x`` bit for bit) and
vectorized in numpy — no per-row Python loops on the hot decode path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["packed_code_width", "pack_codes", "unpack_codes",
           "encode_keys", "PackedCodes", "PackedKeys"]


# ---------------------------------------------------------------------------
# Bit-packed SAX codes
# ---------------------------------------------------------------------------

def packed_code_width(w: int, b: int) -> int:
    """Bytes per packed code row: ``ceil(w*b/8)``."""
    return -(-(w * b) // 8)


def pack_codes(codes: np.ndarray, b: int) -> np.ndarray:
    """``[N, w]`` full-byte codes -> ``[N, ceil(w*b/8)]`` packed uint8.

    Symbol ``j`` of a row occupies bits ``[j*b, (j+1)*b)`` of that row's
    packed bytes, MSB-first; the final partial byte is zero-padded.
    """
    codes = np.ascontiguousarray(codes, np.uint8)
    if codes.ndim != 2:
        raise ValueError(f"codes must be 2-D, got shape {codes.shape}")
    if b == 8:
        return codes
    n, w = codes.shape
    if n == 0:
        return np.zeros((0, packed_code_width(w, b)), np.uint8)
    bits = np.unpackbits(codes[:, :, None], axis=2, count=8)[:, :, 8 - b:]
    return np.packbits(bits.reshape(n, w * b), axis=1)


def unpack_codes(packed: np.ndarray, w: int, b: int) -> np.ndarray:
    """``[N, ceil(w*b/8)]`` packed uint8 -> ``[N, w]`` full-byte codes."""
    packed = np.ascontiguousarray(packed, np.uint8)
    if b == 8:
        return packed
    squeeze = packed.ndim == 1
    if squeeze:
        packed = packed[None, :]
    n = packed.shape[0]
    if n == 0:
        out = np.zeros((0, w), np.uint8)
        return out[0] if squeeze else out
    bits = np.unpackbits(packed, axis=1, count=w * b).reshape(n, w, b)
    weight = (1 << np.arange(b - 1, -1, -1, dtype=np.uint8))
    out = (bits * weight[None, None, :]).sum(axis=2).astype(np.uint8)
    return out[0] if squeeze else out


class PackedCodes:
    """Decoding view over a packed code column (mmap or ndarray).

    Indexing (int / slice / fancy) reads only the touched packed rows and
    decodes them to full-byte ``[., w]`` uint8 — so existing call sites
    written against the v1 memmap keep working unchanged.  ``.packed``
    exposes the raw storage for paths that scan without decoding (the
    fused unpack+mindist kernel, the leaf cache, verbatim merge copies).
    """

    def __init__(self, packed, w: int, b: int):
        self._packed = packed
        self.w = int(w)
        self.b = int(b)

    @property
    def packed(self):
        return self._packed

    @property
    def packed_row_bytes(self) -> int:
        return packed_code_width(self.w, self.b)

    @property
    def shape(self):
        return (len(self._packed), self.w)

    @property
    def dtype(self):
        return np.dtype(np.uint8)

    @property
    def nbytes(self) -> int:
        """Logical (decoded) size; the stored size is ``packed.nbytes``."""
        return len(self._packed) * self.w

    def __len__(self) -> int:
        return len(self._packed)

    def __getitem__(self, idx) -> np.ndarray:
        return unpack_codes(np.asarray(self._packed[idx]), self.w, self.b)

    def __array__(self, dtype=None, copy=None):
        out = unpack_codes(np.asarray(self._packed), self.w, self.b)
        return out.astype(dtype) if dtype is not None else out


# ---------------------------------------------------------------------------
# Delta + zigzag-varint keys
# ---------------------------------------------------------------------------

def _zigzag(v: np.ndarray) -> np.ndarray:
    """int64 -> uint64 zigzag (small magnitudes -> small values)."""
    return ((v << 1) ^ (v >> 63)).view(np.uint64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    zi = z.astype(np.int64, copy=False)
    return (zi >> 1) ^ -(zi & 1)


def _varint_encode(z: np.ndarray) -> np.ndarray:
    """uint64 values -> concatenated LEB128 bytes (vectorized)."""
    if len(z) == 0:
        return np.zeros(0, np.uint8)
    nb = np.ones(len(z), np.int64)
    for shift in (7, 14, 21, 28, 35, 42, 49, 56, 63):
        nb += (z >= np.uint64(1) << np.uint64(shift)).astype(np.int64)
    ends = np.cumsum(nb)
    starts = ends - nb
    buf = np.zeros(int(ends[-1]), np.uint8)
    for bi in range(10):
        m = nb > bi
        if not m.any():
            break
        vals = ((z[m] >> np.uint64(7 * bi)) & np.uint64(0x7F)).astype(
            np.uint8)
        cont = (nb[m] - 1 > bi).astype(np.uint8) << 7
        buf[starts[m] + bi] = vals | cont
    return buf


def _varint_decode(buf: np.ndarray, count: int) -> np.ndarray:
    """LEB128 bytes -> ``count`` uint64 values (vectorized reduceat)."""
    if count == 0:
        return np.zeros(0, np.uint64)
    buf = np.asarray(buf, np.uint8)
    ends_mask = (buf & 0x80) == 0
    end_pos = np.nonzero(ends_mask)[0]
    if len(end_pos) < count:
        raise ValueError("truncated varint stream")
    starts = np.empty(count, np.int64)
    starts[0] = 0
    starts[1:] = end_pos[:count - 1] + 1
    used = int(end_pos[count - 1]) + 1
    buf = buf[:used]
    vid = np.cumsum(np.concatenate(([0], ends_mask[:used - 1]))
                    .astype(np.int64))
    pos = np.arange(used, dtype=np.int64) - starts[vid]
    shifted = (buf & 0x7F).astype(np.uint64) << (7 * pos).astype(np.uint64)
    return np.add.reduceat(shifted, starts)


def _encode_key_leaf(rows: np.ndarray) -> bytes:
    """One leaf of sorted ``[m, nw]`` uint32 keys -> encoded bytes."""
    rows = np.ascontiguousarray(rows, np.uint32)
    out = rows[0].astype("<u4").tobytes()
    if len(rows) > 1:
        delta = rows[1:].astype(np.int64) - rows[:-1].astype(np.int64)
        out += _varint_encode(_zigzag(delta.ravel())).tobytes()
    return out


def encode_keys(keys: np.ndarray, leaf_size: int) -> np.ndarray:
    """Sorted ``[N, nw]`` uint32 keys -> the v3 keys column blob.

    Layout: ``uint64[n_leaves + 1]`` little-endian byte offsets (the leaf
    directory; entry 0 points just past the directory, the last entry is
    the blob length), followed by each leaf's encoded block.
    """
    keys = np.ascontiguousarray(keys, np.uint32)
    n = len(keys)
    n_leaves = -(-n // leaf_size) if n else 0
    blocks = [_encode_key_leaf(keys[s:s + leaf_size])
              for s in range(0, n, leaf_size)]
    offs = np.zeros(n_leaves + 1, np.uint64)
    offs[0] = 8 * (n_leaves + 1)
    for i, blk in enumerate(blocks):
        offs[i + 1] = offs[i] + len(blk)
    parts = [offs.astype("<u8").tobytes()] + blocks
    return np.frombuffer(b"".join(parts), np.uint8)


class PackedKeys:
    """Decoding view over a v3 delta+varint keys column blob.

    Behaves like the old ``[N, n_words]`` uint32 memmap for indexing, but
    decodes leaf-at-a-time through the directory so a one-leaf probe
    touches only that leaf's bytes.  ``leaf_nbytes`` reports a leaf's
    *stored* size — what a cache hit on the leaf actually saves.
    """

    def __init__(self, blob, n: int, n_words: int, leaf_size: int):
        self._blob = blob
        self.n = int(n)
        self.n_words = int(n_words)
        self.leaf_size = int(leaf_size)
        self.n_leaves = -(-self.n // self.leaf_size) if self.n else 0
        head = np.asarray(blob[:8 * (self.n_leaves + 1)], np.uint8)
        self._dir = np.frombuffer(head.tobytes(), "<u8").astype(np.int64)

    @property
    def shape(self):
        return (self.n, self.n_words)

    @property
    def dtype(self):
        return np.dtype(np.uint32)

    @property
    def nbytes(self) -> int:
        """Logical (decoded) size; stored size is ``stored_nbytes``."""
        return self.n * self.n_words * 4

    @property
    def stored_nbytes(self) -> int:
        return len(self._blob)

    def __len__(self) -> int:
        return self.n

    def leaf_nbytes(self, li: int) -> int:
        """Stored bytes of leaf ``li`` (the cache's saved-bytes figure)."""
        return int(self._dir[li + 1] - self._dir[li])

    def decode_leaf(self, li: int) -> np.ndarray:
        """Leaf ``li`` as decoded ``[m, n_words]`` uint32 rows."""
        s, e = int(self._dir[li]), int(self._dir[li + 1])
        m = min(self.leaf_size, self.n - li * self.leaf_size)
        nw = self.n_words
        raw = np.asarray(self._blob[s:e], np.uint8)
        first = np.frombuffer(raw[:4 * nw].tobytes(), "<u4")
        if m == 1:
            return first[None, :].astype(np.uint32)
        z = _varint_decode(raw[4 * nw:], (m - 1) * nw)
        delta = _unzigzag(z).reshape(m - 1, nw)
        words = np.cumsum(
            np.vstack([first.astype(np.int64), delta]), axis=0)
        return words.astype(np.uint32)

    def _decode_range(self, s: int, e: int) -> np.ndarray:
        if e <= s:
            return np.zeros((0, self.n_words), np.uint32)
        l0, l1 = s // self.leaf_size, (e - 1) // self.leaf_size
        parts = [self.decode_leaf(li) for li in range(l0, l1 + 1)]
        block = parts[0] if len(parts) == 1 else np.concatenate(parts)
        base = l0 * self.leaf_size
        return block[s - base:e - base]

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            i = int(idx)
            if i < 0:
                i += self.n
            li = i // self.leaf_size
            return self.decode_leaf(li)[i - li * self.leaf_size]
        if isinstance(idx, slice):
            s, e, step = idx.indices(self.n)
            out = self._decode_range(s, e)
            return out[::step] if step != 1 else out
        idx = np.asarray(idx)
        if len(idx) == 0:
            return np.zeros((0, self.n_words), np.uint32)
        out = np.empty((len(idx), self.n_words), np.uint32)
        leaves = idx // self.leaf_size
        for li in np.unique(leaves):
            m = leaves == li
            out[m] = self.decode_leaf(int(li))[idx[m] - li * self.leaf_size]
        return out

    def __array__(self, dtype=None, copy=None):
        out = self._decode_range(0, self.n)
        return out.astype(dtype) if dtype is not None else out
