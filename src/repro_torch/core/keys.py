"""Multi-word z-order (Morton) keys for sortable summarizations.

The paper's Algorithm 1 (``invertSum``) interleaves the bits of the ``w`` SAX
segments so that all most-significant bits precede all less-significant bits.
With the paper's default of ``w=16`` segments at ``b=8`` bits each, the
interleaved key is 128 bits wide, held as ``[N, n_words]`` 32-bit words,
**big-endian**: word 0 holds the 32 most-significant interleaved bits.

Bit layout (MSB-first global bit position p in [0, w*b)):
    p = i * w + j   <=>   bit (b-1-i) of segment j        (i=0 is each
segment's most-significant bit), exactly the paper's inverted layout.

Each 32-bit word is held in ``int64`` with values in ``[0, 2**32)``:
``torch.uint32`` supports too few operations for the compares and sorts
below.  The CUDA ``fused_build`` kernel writes the same int64 words and is
checked against :func:`interleave_codes`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "n_key_words",
    "interleave_codes",
    "deinterleave_key",
    "lexsort_keys",
    "lexsort_keys_np",
    "count_below_np",
    "key_extremes_np",
    "key_less",
    "key_less_equal",
    "searchsorted_keys",
    "keys_to_bigint",
    "bigint_to_key",
]

_WORD = 32


def n_key_words(w: int, b: int) -> int:
    """Number of 32-bit words needed for a ``w``-segment, ``b``-bit key."""
    return max(1, -(-(w * b) // _WORD))


def interleave_codes(codes: torch.Tensor, *, w: int, b: int) -> torch.Tensor:
    """Pack SAX codes ``[N, w]`` (values < 2**b) into z-order keys
    ``[N, n_words]`` int64: global bit ``p = i*w + j`` (MSB first) takes
    bit ``(b-1-i)`` of segment ``j``; a last word the bits do not fill is
    left-aligned (MSB side), which preserves lexicographic order."""
    if codes.ndim != 2 or codes.shape[1] != w:
        raise ValueError(f"codes must be [N, {w}], got {tuple(codes.shape)}")
    dev = codes.device
    nw = n_key_words(w, b)
    n = codes.shape[0]
    shifts = (b - 1 - torch.arange(b, device=dev))[None, :, None]
    bits = (codes.to(torch.int64)[:, None, :] >> shifts) & 1    # [N, b, w]
    flat = bits.reshape(n, b * w)                               # p = i*w + j
    pad = nw * _WORD - b * w
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    weights = 1 << (_WORD - 1 - torch.arange(_WORD, device=dev))
    return (flat.reshape(n, nw, _WORD) * weights).sum(-1)


def deinterleave_key(keys: torch.Tensor, *, w: int, b: int) -> torch.Tensor:
    """Inverse of :func:`interleave_codes`: keys ``[N, words]`` -> codes
    ``[N, w]`` (int64).  The paper stresses that sortable summarizations
    carry *identical* information (Sec. 4.1): this recovers the SAX word."""
    nw = n_key_words(w, b)
    if keys.ndim != 2 or keys.shape[1] != nw:
        raise ValueError(f"keys must be [N, {nw}], got {tuple(keys.shape)}")
    dev = keys.device
    n = keys.shape[0]
    shifts = (_WORD - 1 - torch.arange(_WORD, device=dev))
    bits = (keys.to(torch.int64)[:, :, None] >> shifts) & 1     # [N, nw, 32]
    bits = bits.reshape(n, nw * _WORD)[:, : w * b].reshape(n, b, w)
    weights = (1 << (b - 1 - torch.arange(b, device=dev)))[None, :, None]
    return (bits * weights).sum(1)


def _packed_columns(keys: torch.Tensor):
    """Sort columns, most significant first: each pair of 32-bit words
    packed into one int64 as ``(hi - 2**31) * 2**32 + lo`` (the unsigned
    128-bit order with its top bit flipped, so signed order equals the
    order of (hi, lo), and no step overflows); an odd last word stands
    alone (it fits int64 as is)."""
    cols = []
    nw = keys.shape[1]
    for k in range(0, nw - 1, 2):
        cols.append((keys[:, k] - (1 << 31)) * (1 << _WORD)
                    + keys[:, k + 1])
    if nw % 2:
        cols.append(keys[:, nw - 1])
    return cols


def lexsort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting multi-word keys lexicographically (word 0
    primary), stable: one ``torch.sort(stable=True)`` per packed column,
    least significant first.  The paper's "external sort" on device."""
    perm = torch.arange(keys.shape[0], device=keys.device)
    for col in reversed(_packed_columns(keys)):
        _, o = torch.sort(col[perm], stable=True)
        perm = perm[o]
    return perm


def key_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a < b`` for ``[..., words]`` keys (broadcasts)."""
    nw = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    less = torch.zeros(shape, dtype=torch.bool, device=a.device)
    eq = torch.ones_like(less)
    for k in range(nw):
        ak, bk = a[..., k], b[..., k]
        less = less | (eq & (ak < bk))
        eq = eq & (ak == bk)
    return less


def key_less_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ~key_less(b, a)


def searchsorted_keys(sorted_keys: torch.Tensor, query_keys: torch.Tensor,
                      side: str = "left") -> torch.Tensor:
    """Vectorized lexicographic binary search over multi-word keys.

    ``sorted_keys``: ``[N, words]`` sorted ascending (lexicographically).
    ``query_keys``:  ``[Q, words]``.
    Returns ``[Q]`` int64 insertion points — the static sorted array +
    fence pointers need only binary search (log2 N probes).
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    n = sorted_keys.shape[0]
    q = query_keys.shape[0]
    dev = query_keys.device
    lo = torch.zeros(q, dtype=torch.int64, device=dev)
    hi = torch.full((q,), n, dtype=torch.int64, device=dev)
    steps = max(1, int(np.ceil(np.log2(max(n, 1) + 1))) + 1)
    if n == 0:
        return lo
    for _ in range(steps):
        mid = (lo + hi) // 2
        mid_keys = sorted_keys[mid.clamp(0, n - 1)]
        if side == "left":
            go_right = key_less(mid_keys, query_keys)          # a[mid] <  q
        else:
            go_right = key_less_equal(mid_keys, query_keys)    # a[mid] <= q
        open_ = lo < hi
        lo = torch.where(go_right & open_, mid + 1, lo)
        hi = torch.where((~go_right) & open_, mid, hi)
    return lo


def lexsort_keys_np(keys: np.ndarray) -> np.ndarray:
    """Host-side twin of :func:`lexsort_keys`: the permutation sorting
    ``[N, n_words]`` keys lexicographically (word 0 primary)."""
    keys = np.asarray(keys)
    return np.lexsort(tuple(keys[:, k]
                            for k in range(keys.shape[1] - 1, -1, -1)))


def count_below_np(sorted_keys: np.ndarray, key: np.ndarray, *,
                   inclusive: bool = False) -> int:
    """Rows of the sorted ``[m, n_words]`` block lexicographically below
    ``key`` (or equal to it when ``inclusive``): the host-side insertion
    point of :func:`searchsorted_keys` (side ``"left"`` / ``"right"``),
    in one vectorized pass over a block small enough to scan."""
    lt = np.zeros(len(sorted_keys), bool)
    eq = np.ones(len(sorted_keys), bool)
    for w in range(sorted_keys.shape[1]):
        lt |= eq & (sorted_keys[:, w] < key[w])
        eq &= sorted_keys[:, w] == key[w]
    return int(np.count_nonzero(lt | eq if inclusive else lt))


def key_extremes_np(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Lexicographic (min_row, max_row) of ``[N, n_words]`` keys in
    O(N * n_words) — no sort.  Successive word filtering: keep the rows
    matching the extreme of each word in turn."""
    keys = np.asarray(keys, np.uint32)
    lo = hi = np.arange(len(keys))
    for w in range(keys.shape[1]):
        col = keys[lo, w]
        lo = lo[col == col.min()]
        col = keys[hi, w]
        hi = hi[col == col.max()]
    return keys[lo[0]], keys[hi[0]]


# ---------------------------------------------------------------------------
# Host-side oracles (numpy / python bigint) for property tests.
# ---------------------------------------------------------------------------

def keys_to_bigint(keys: np.ndarray) -> list:
    """[N, words] 32-bit words -> python big ints (oracle comparisons)."""
    keys = np.asarray(keys, dtype=np.uint32)
    out = []
    for row in keys:
        v = 0
        for word in row:
            v = (v << 32) | int(word)
        out.append(v)
    return out


def bigint_to_key(v: int, n_words: int) -> np.ndarray:
    words = []
    for k in range(n_words - 1, -1, -1):
        words.append((v >> (32 * k)) & 0xFFFFFFFF)
    return np.array(words, dtype=np.uint32)


def interleave_oracle(codes: np.ndarray, w: int, b: int) -> list:
    """Python big-int oracle of the paper's Algorithm 1 (MSB-first)."""
    codes = np.asarray(codes)
    out = []
    total = w * b
    pad = n_key_words(w, b) * 32 - total
    for row in codes:
        v = 0
        for p in range(total):
            i, j = divmod(p, w)
            bit = (int(row[j]) >> (b - 1 - i)) & 1
            v = (v << 1) | bit
        out.append(v << pad)  # left-align into the word grid
    return out
