"""The plain reference that decides ``correct``, and its lower-precision
controls.

Plain PyTorch, computed in blocks of rows on the rows' device; it imports
nothing of the program and takes nothing the program made.  The inputs
(the walks, the queries, the streamed rows) are the benchmark's own; the
program's outputs (answers, a tree's columns) are read here only to be
judged.

* :func:`knn`: exact k-NN by squared Euclidean distance over a range of
  rows.  ``precision="fp32"`` (TF32 off): each block's nearest ``PRE``
  candidates by one float32 GEMM in the expanded form, re-scored by the
  direct difference-square sum.  ``precision="tf32"`` is the control:
  the expanded form with both operands rounded to TF32's 10-bit
  mantissa (what a tensor-core GEMM does to float32 inputs), products
  summed in float32, no re-scoring.
* :func:`direct`: the direct distance of given (query, row) pairs.
* :func:`build_reference`: the summaries, keys and stable sort order a
  Coconut build of the rows must give (``summaries``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import summaries

BLOCK = 1 << 20      # rows a block
PRE = 64             # candidates a query takes from each block


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits, round to
    nearest even), as a tensor core reads a float32 operand."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def direct(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[Q, C]`` of queries ``[Q, L]`` to rows
    ``[Q, C, L]``: the direct difference-square sum in float32."""
    diff = rows - q[:, None, :]
    return (diff * diff).sum(-1)


def knn(rows: torch.Tensor, lo: int, hi: int, queries: torch.Tensor, k: int,
        precision: str = "fp32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of ``queries`` ``[Q, L]`` over ``rows[lo:hi]``: (squared
    distances ``[Q, k]`` ascending, row numbers ``[Q, k]``), ties to the
    lower row."""
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    _no_tf32()
    q = queries.to(rows.device, torch.float32)
    qn = (q * q).sum(1, keepdim=True)
    qt = tf32(q)
    cand_d, cand_i = [], []
    for s in range(lo, hi, BLOCK):
        blk = rows[s:min(s + BLOCK, hi)]
        xn = (blk * blk).sum(1)[None, :]
        if precision == "tf32":
            d = qn + xn - 2.0 * (qt @ tf32(blk).T)
            take = min(k, blk.shape[0])
            vals, sel = torch.topk(d, take, dim=1, largest=False)
            cand_d.append(vals)
            cand_i.append(sel + s)
            continue
        approx = qn + xn - 2.0 * (q @ blk.T)
        sel = torch.topk(approx, min(PRE, blk.shape[0]), dim=1,
                         largest=False).indices
        cand_d.append(direct(q, blk[sel]))
        cand_i.append(sel + s)
    d = torch.cat(cand_d, 1)
    i = torch.cat(cand_i, 1)
    # ascending distance, ties to the lower row: sort by row, then stably
    # by distance
    o = torch.argsort(i, dim=1)
    d, i = torch.gather(d, 1, o), torch.gather(i, 1, o)
    o = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(d, 1, o), torch.gather(i, 1, o)


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """``max |a - b| / b`` over finite ``b``; inf where ``a`` is not finite
    and ``b`` is."""
    a = a.double()
    b = b.double()
    fin = torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0
    if not bool(torch.isfinite(a[fin]).all()):
        return float("inf")
    return float(((a[fin] - b[fin]).abs()
                  / b[fin].clamp_min(1e-30)).max())


# ---------------------------------------------------------------------------
# a Coconut build
# ---------------------------------------------------------------------------

def build_reference(rows: torch.Tensor, segments: int, bits: int,
                    dtype=torch.float32):
    """(PAA, codes, keys) of every row, in row order, and the stable sort
    order of the keys: what a build over ``rows`` must give.
    ``dtype=torch.bfloat16`` is the control."""
    parts = [summaries.summarize(rows[s:s + BLOCK], segments, bits, dtype)
             for s in range(0, rows.shape[0], BLOCK)]
    paas = torch.cat([p[0] for p in parts])
    codes = torch.cat([p[1] for p in parts])
    keys = torch.cat([p[2] for p in parts])
    return paas, codes, keys, summaries.lexsort_keys(keys)


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return x.contiguous().view(torch.int32)
    return x


def build_mismatches(rows: torch.Tensor, ref, tree_cols) -> int:
    """Rows of a built tree whose offset, PAA, codes, keys or raw row
    differ from the reference's, in sorted order.  ``tree_cols``:
    (offsets, paas, codes, keys, raw) as the tree holds them (raw may be
    None: not materialized)."""
    r_paa, r_codes, r_keys, r_order = ref
    offs, paas, codes, keys, raw = tree_cols
    n = rows.shape[0]
    if offs.shape[0] != n:
        return max(n, offs.shape[0])
    bad = 0
    for s in range(0, n, BLOCK):
        o = r_order[s:s + BLOCK]
        m = offs[s:s + BLOCK] != o
        m |= (_bits(paas[s:s + BLOCK].float()) != _bits(
            r_paa[o].float())).any(1)
        m |= (codes[s:s + BLOCK] != r_codes[o]).any(1)
        m |= (keys[s:s + BLOCK] != r_keys[o]).any(1)
        if raw is not None:
            m |= (_bits(raw[s:s + BLOCK]) != _bits(rows[o])).any(1)
        bad += int(m.sum())
    return bad
