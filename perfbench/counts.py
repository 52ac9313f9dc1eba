"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes each kernel family needs for the work a window did.

Peaks of one H100 SXM (NVIDIA's data sheet), frozen from
``chip_smoke.py``: 3.35 TB/s of HBM; 33.5e12 FP32 instructions a second
(128 lanes x 132 SMs x 1.98 GHz: the data sheet's 67 TFLOP/s counts a
fused multiply-add as two, and the port's kernels forbid FMA contraction,
so each sub, mul and add is one instruction).

Counts follow what the inputs need, each input byte once, taken from the
program's own per-batch accounting (``SearchStats``); where the need is
not known from the accounting the count leaves it out, so a share of the
roofline can only read low, never high.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time for moving ``nbytes`` and issuing ``ops`` FP32
    instructions: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def mindist_need(nq: int, rows: int, w: int):
    """(bytes, ops) of the iSAX bound of ``nq`` queries over ``rows``
    scanned rows: every scanned row's w code bytes once; per (query, row)
    a sub, a mul and an add per segment."""
    return rows * w, nq * rows * 3 * w


def euclid_need(pairs: int, distinct_rows: int, nq: int, L: int):
    """(bytes, ops) of verification: the verified rows' raw bytes and the
    queries once; per live (query, row) pair L subs, L muls and L - 1
    adds."""
    return (distinct_rows + nq) * L * 4, pairs * (3 * L - 1)


def scanned_rows(leaves_scanned: int, leaf_size: int, n_rows: int) -> int:
    """Rows the bound scanned: whole leaves, at most the partitions' rows
    (a last leaf may be short)."""
    return min(leaves_scanned * leaf_size, n_rows)


def search_bounds(stats, nq: int, L: int, w: int, leaf_size: int,
                  sorted_rows: int):
    """(mindist bound s, euclid bound s) of one batch from its
    ``SearchStats``: the bound over every scanned leaf; verification over
    the verified (query, row) pairs, the buffer's pairs included
    (``candidates_per_query`` counts both), and the distinct verified
    rows plus the buffer rows."""
    rows = scanned_rows(stats.leaves_scanned, leaf_size, sorted_rows)
    mb, mo = mindist_need(nq, rows, w)
    pairs = int(stats.candidates_per_query.sum()) \
        if stats.candidates_per_query is not None else 0
    eb, eo = euclid_need(pairs, stats.candidates + stats.buffer_rows, nq, L)
    return bound_s(mb, mo), bound_s(eb, eo)
