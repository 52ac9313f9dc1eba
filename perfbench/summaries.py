"""Frozen copy of the plain PAA / SAX / z-order arithmetic (paper Secs. 2,
4.1), the reference for what a Coconut build must produce.

Copied from ``src/repro_torch/core/summarization.py`` (``paa``,
``breakpoints``, ``sax_encode``) and ``src/repro_torch/core/keys.py``
(``interleave_codes``, ``lexsort_keys``, and ``searchsorted_keys`` as
:func:`searchsorted_packed`).  Plain PyTorch on the tensor's
own device; imports nothing of the program.

``paa`` sums each segment in index order and then divides, as the paper
defines it, so in float32 it gives the same bits on any device.  Its
``dtype`` argument exists for the control (the same arithmetic in
bfloat16, the precision below the configuration's float32).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import ndtri

_WORD = 32


def n_key_words(w: int, b: int) -> int:
    return max(1, -(-(w * b) // _WORD))


def breakpoints(bits: int, device=None) -> torch.Tensor:
    """Standard-normal quantile breakpoints: 2**b - 1 boundaries, from the
    inverse normal CDF in float64 rounded once to float32."""
    card = 1 << bits
    qs = np.arange(1, card, dtype=np.float64) / card
    return torch.tensor(ndtri(qs).astype(np.float32), device=device)


def paa(x: torch.Tensor, segments: int, dtype=torch.float32) -> torch.Tensor:
    """Piecewise Aggregate Approximation ``[..., L] -> [..., w]``: each
    segment summed in index order, then divided by its length."""
    *lead, L = x.shape
    seg = L // segments
    r = x.to(dtype).reshape(*lead, segments, seg)
    acc = r[..., 0]
    for e in range(1, seg):
        acc = acc + r[..., e]
    return acc / torch.full((), seg, dtype=dtype, device=acc.device)


def sax_encode(paa_vals: torch.Tensor, bits: int) -> torch.Tensor:
    """SAX codes ``[..., w]`` (uint8): the number of breakpoints <= value."""
    bps = breakpoints(bits, device=paa_vals.device).to(paa_vals.dtype)
    return torch.searchsorted(bps, paa_vals.contiguous(),
                              right=True).to(torch.uint8)


def interleave_codes(codes: torch.Tensor, w: int, b: int) -> torch.Tensor:
    """SAX codes ``[N, w]`` -> z-order keys ``[N, n_words]`` int64 words of
    32 bits, big-endian: global bit ``p = i*w + j`` (MSB first) takes bit
    ``(b-1-i)`` of segment ``j``; a last word the bits do not fill is
    left-aligned."""
    dev = codes.device
    nw = n_key_words(w, b)
    n = codes.shape[0]
    shifts = (b - 1 - torch.arange(b, device=dev))[None, :, None]
    bits = (codes.to(torch.int64)[:, None, :] >> shifts) & 1
    flat = bits.reshape(n, b * w)
    pad = nw * _WORD - b * w
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    weights = 1 << (_WORD - 1 - torch.arange(_WORD, device=dev))
    return (flat.reshape(n, nw, _WORD) * weights).sum(-1)


def packed_keys(keys: torch.Tensor) -> torch.Tensor:
    """``[N, words]`` keys -> ``[N, ceil(words / 2)]`` int64 columns in the
    same lexicographic order: pairs of words packed into one int64 with
    the top bit flipped."""
    cols = []
    nw = keys.shape[1]
    for k in range(0, nw - 1, 2):
        cols.append((keys[:, k] - (1 << 31)) * (1 << _WORD) + keys[:, k + 1])
    if nw % 2:
        cols.append(keys[:, nw - 1])
    return torch.stack(cols, 1)


def lexsort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting ``[N, words]`` keys lexicographically
    (word 0 primary): one stable sort per packed column
    (:func:`packed_keys`), least significant first."""
    cols = packed_keys(keys)
    perm = torch.arange(keys.shape[0], device=keys.device)
    for j in reversed(range(cols.shape[1])):
        _, o = torch.sort(cols[perm, j], stable=True)
        perm = perm[o]
    return perm


def searchsorted_packed(sorted_cols: torch.Tensor,
                        q_cols: torch.Tensor) -> torch.Tensor:
    """``[Q]`` insertion points (left: the count of keys below) of packed
    query keys ``[Q, c]`` in packed keys ``[N, c]`` sorted
    lexicographically, narrowing one column at a time."""
    out = []
    for q in q_cols:
        lo, hi = 0, sorted_cols.shape[0]
        for j in range(sorted_cols.shape[1]):
            col = sorted_cols[lo:hi, j].contiguous()
            v = q[j:j + 1]
            left = lo + int(torch.searchsorted(col, v))
            if j + 1 == sorted_cols.shape[1]:
                lo = left
                break
            lo, hi = left, lo + int(torch.searchsorted(col, v, right=True))
            if lo == hi:
                break
        out.append(lo)
    return torch.tensor(out, dtype=torch.int64, device=sorted_cols.device)


def summarize(x: torch.Tensor, segments: int, bits: int,
              dtype=torch.float32):
    """Rows ``[N, L]`` -> (PAA ``[N, w]``, codes ``[N, w]``, keys)."""
    p = paa(x, segments, dtype)
    c = sax_encode(p, bits)
    return p, c, interleave_codes(c, segments, bits)
