"""The launch plan and arithmetic of the bound tile, checked on the CPU.

``mindist_batch`` and ``unpack_mindist`` share one CUDA tile
(``csrc/bound_tile.cuh``) whose launch is computed in Python by
``repro_torch.kernels.mindist_batch.launch_plan``: a block of ``ROWS``
threads (the kernel's ``kRows``), each holding one row and the block's
``qt`` queries, and the grid over row and query tiles.  These tests hold
the plan and the kernel's constants, read from its source, to what the
kernel needs (every (query, row) pair computed once, whole warps along the
rows, at most 48 KB of shared memory so no ``cudaFuncSetAttribute``, a
staged row stride whose 32 lanes read 32 banks), and check that shapes the
kernels do not take are refused.

Numpy models of the kernel's arithmetic are held against the plain twins
bit for bit (the tolerance is none: both do the same float32 operations in
the same order): the tile's per-pair order (w terms in index order, each
``(max(lo - q, 0) + max(q - hi, 0))**2`` with one rounding per operation,
then the scale), and the staging of packed rows (aligned 4-byte words,
funnel-shifted, at the padded stride) followed by the two-byte-window
unpack.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import summarization as S
from repro_torch.kernels import mindist_batch as mb
from repro_torch.kernels import ref
from repro_torch.kernels.mindist_batch import (MAX_QT, MAX_W, ROWS, SMS,
                                               launch_plan)
from repro_torch.storage.packing import pack_codes

LANES = 32
CSRC = Path(mb.__file__).parent / "csrc"
# the kernel's constants, as its source declares them
KC = {k: int(v) for f in ("common.cuh", "bound_tile.cuh") for k, v in
      re.findall(r"constexpr int (k\w+) = (\d+);", (CSRC / f).read_text())}
STRIDE = KC["kStageStride"]

QS = (1, 3, 16, 17, 64, 65)
# every edge of one and two row tiles, and a leaf and a bit
NS = (1, ROWS - 1, ROWS, ROWS + 1, 2 * ROWS - 1, 2 * ROWS, 2 * ROWS + 1,
      2037)
F32 = np.float32


def _ceil(a, b):
    return -(-a // b)


def _pairs_of(p, nq, n):
    """Each (query, row) pair as the kernel computes it: thread tx of
    block (bx, by) holds row bx * ROWS + tx and queries by * qt + i for
    i < qt; pairs past Q or N are not stored."""
    count = np.zeros((nq, n), dtype=np.int64)
    tx = np.arange(ROWS)
    for by in range(p.grid[1]):
        for bx in range(p.grid[0]):
            r = bx * ROWS + tx
            for i in range(p.qt):
                q = by * p.qt + i
                ok = (r < n) & (q < nq)
                np.add.at(count, (np.full(ok.sum(), q), r[ok]), 1)
    return count


@pytest.mark.parametrize("nq", QS)
def test_plan_covers_every_pair_once(nq):
    for n in NS:
        p = launch_plan(nq, n, 16)
        assert (_pairs_of(p, nq, n) == 1).all(), (nq, n, p)


@pytest.mark.parametrize("nq", QS)
def test_plan_shape_of_a_block(nq):
    """Whole warps of one row each (a block shares its queries, so their
    PAAs are broadcast reads), the kernel's own row tile and widest word,
    and a query tile that is the next power of two of Q up to 4, halved
    while the grid has fewer blocks than the card has SMs."""
    assert ROWS == KC["kRows"] and ROWS % LANES == 0
    assert MAX_QT == KC["kMaxQT"] and MAX_W == KC["kMaxW"]
    for n in NS:
        p = launch_plan(nq, n, 16)
        assert p.qt in (1, 2, 4)
        full = min(MAX_QT, 1 << (nq - 1).bit_length())
        assert p.qt <= full
        blocks = _ceil(n, ROWS) * _ceil(nq, p.qt)
        assert p.qt == full or blocks < 2 * SMS
        assert p.qt == 1 or blocks >= SMS
        assert p.grid == (_ceil(n, ROWS), _ceil(nq, p.qt))


def test_plan_fills_the_card_at_the_main_path():
    """Q=64 x one 2000-row leaf: 512 blocks, every SM busy (the first
    design launched 32); a 175-row launch takes one query a thread."""
    p = launch_plan(64, 2000, 16)
    assert p.grid[0] * p.grid[1] >= SMS
    assert (ROWS, p.qt) == (64, 4)
    assert p.grid == (32, 16)
    assert launch_plan(64, 175, 16).grid == (3, 64)
    assert launch_plan(1, 2000, 16).grid == (32, 1)


@pytest.mark.parametrize("w", (1, 8, 16, 64))
def test_plan_fits_default_shared_memory(w):
    """The kernel's static shared arrays: the [256] float2 region table,
    kMaxW x qt query PAAs and, for staged rows (b < 8), kRows rows of
    kStageStride words, which hold the packed row."""
    for b in range(1, 9):
        pw = _ceil(w * b, 8)
        for nq in QS:
            p = launch_plan(nq, 2000, w)
            staged = 4 * KC["kRows"] * STRIDE if b < 8 else 0
            smem = KC["kTabEntries"] * 8 + 4 * KC["kMaxW"] * p.qt + staged
            assert smem <= 48 * 1024
            assert b == 8 or 4 * STRIDE >= pw


@pytest.mark.parametrize("w", (1, 8, 16, 64))
def test_plan_staged_stride_is_conflict_free(w):
    """A staged row takes an odd number of 4-byte words, at least its
    bytes: the 32 lanes of a warp read byte m of rows r..r+31 from 32
    different banks, for every m."""
    assert STRIDE % 2 == 1
    for b in range(1, 8):
        pw = _ceil(w * b, 8)
        assert 4 * STRIDE >= pw
        lanes = np.arange(LANES)
        for m in range(pw):
            banks = (lanes * STRIDE + m // 4) % 32
            assert len(set(banks)) == 32, (w, b, m)


def test_plan_cache_is_keyed_on_its_arguments():
    mb.launch_plan.cache_clear()
    for _ in range(3):
        launch_plan(64, 2000, 16)
    info = mb.launch_plan.cache_info()
    assert (info.currsize, info.misses, info.hits) == (1, 1, 2)


@pytest.mark.parametrize("bad", [
    dict(nq=0), dict(n=0), dict(n=2 ** 31), dict(w=0), dict(w=65),
    dict(nq=-1), dict(nq=65_536 * MAX_QT)])
def test_plan_refuses_shapes_the_kernels_do_not_take(bad):
    args = dict(nq=64, n=2000, w=16)
    args.update(bad)
    with pytest.raises(ValueError):
        launch_plan(**args)


def _inputs(seed, nq, n, w, b):
    """Random codes (the first and last symbols reach the -inf / +inf
    table ends), query PAAs with a quarter exactly on a breakpoint, and
    the [2**b] region tables."""
    rng = np.random.default_rng(seed)
    lower, upper = (t.numpy() for t in S.region_bounds(b))
    codes = rng.integers(0, 1 << b, (n, w), dtype=np.uint8)
    q = rng.standard_normal((nq, w)).astype(F32)
    on = rng.random((nq, w)) < 0.25
    q[on] = upper[rng.integers(0, (1 << b) - 1, on.sum())]
    return q, codes, lower, upper


def _tile_model(q, codes, lower, upper, scale, p):
    """The bound tile's arithmetic in float32, block by block and thread
    by thread: one table pair a segment, the term added to the thread's
    qt accumulators in turn, each term's operations rounded one at a
    time; the scale last."""
    nq, w = q.shape
    n = codes.shape[0]
    out = np.full((nq, n), np.nan, F32)
    zero = F32(0)
    for by in range(p.grid[1]):
        for bx in range(p.grid[0]):
            rows = np.arange(bx * ROWS, min((bx + 1) * ROWS, n))
            qs = [by * p.qt + i for i in range(p.qt)]
            acc = [np.zeros(len(rows), F32) for _ in qs]
            for j in range(w):
                lo = lower[codes[rows, j]]
                hi = upper[codes[rows, j]]
                for i, qi in enumerate(qs):
                    qv = q[qi, j] if qi < nq else zero
                    below = np.maximum(F32(lo - qv), zero)
                    above = np.maximum(F32(qv - hi), zero)
                    d = F32(below + above)
                    acc[i] = F32(acc[i] + F32(d * d))
            for i, qi in enumerate(qs):
                if qi < nq:
                    out[qi, rows] = F32(F32(scale) * acc[i])
    return out


@pytest.mark.parametrize("w,b", [(16, 8), (8, 4), (64, 1), (3, 5)])
@pytest.mark.parametrize("nq", (1, 3, 17))
def test_tile_model_equals_twin_bits(nq, w, b):
    q, codes, lower, upper = _inputs(nq * 100 + w + b, nq, 2 * ROWS + 1, w, b)
    scale = 256 / w
    p = launch_plan(nq, codes.shape[0], w)
    got = _tile_model(q, codes, lower, upper, scale, p)
    want = ref.mindist_batch_ref(torch.from_numpy(q), torch.from_numpy(codes),
                                 torch.from_numpy(lower),
                                 torch.from_numpy(upper), scale).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the ends and the breakpoints were reached: some terms are 0 from an
    # infinite end, some PAAs sit exactly on a region edge
    assert np.isin(q, upper[:-1]).any()


def _staged_model(packed_flat, off, n, w, b, p):
    """unpack_mindist's staging and unpack at b < 8: the array's bytes
    start at ``off`` within aligned 4-byte words; each block copies word k
    of row r (the 4 bytes at r * pw + 4k, from one or two aligned words,
    funnel-shifted; a second word starting past the array reads 0) to
    r * kStageStride + k, then symbol j is read through the two-byte window at
    bit j * b, with a zero byte past the row."""
    pw = _ceil(w * b, 8)
    end = off + n * pw
    raw = packed_flat.tobytes()
    words = np.frombuffer(raw + b"\0" * (4 + (-len(raw)) % 4), np.uint32)
    codes = np.zeros((n, w), np.uint8)
    for bx in range(p.grid[0]):
        r0 = bx * ROWS
        tr = min(ROWS, n - r0)
        smem = np.zeros(ROWS * STRIDE, np.uint32)
        wpr = _ceil(pw, 4)
        for i in range(tr * wpr):
            r, k = divmod(i, wpr)
            addr = off + (r0 + r) * pw + 4 * k
            lo = int(words[addr // 4])
            sh = addr % 4
            hi = int(words[addr // 4 + 1]) if 4 * (addr // 4 + 1) < end else 0
            smem[r * STRIDE + k] = ((hi << 32 | lo) >> (8 * sh)) & 0xFFFFFFFF
        for r in range(tr):
            row = smem[r * STRIDE:(r + 1) * STRIDE]

            def byte(m):
                return (int(row[m >> 2]) >> (8 * (m & 3))) & 0xFF
            for j in range(w):
                bit = j * b
                bl = bit >> 3
                hi_b = byte(bl)
                lo_b = byte(bl + 1) if bl + 1 < pw else 0
                codes[r0 + r, j] = (((hi_b << 8) | lo_b)
                                    >> (16 - (bit & 7) - b)) & ((1 << b) - 1)
    return codes


@pytest.mark.parametrize("w", (1, 8, 16, 64))
def test_staged_unpack_model_equals_twin(w):
    rng = np.random.default_rng(w)
    for b in range(1, 8):
        n = ROWS + 3
        codes = rng.integers(0, 1 << b, (n, w), dtype=np.uint8)
        packed = pack_codes(codes, b)
        pw = packed.shape[1]
        p = launch_plan(8, n, w)
        for off in range(4):             # the view's byte offset in a word
            flat = np.concatenate([rng.integers(0, 256, off, np.uint8),
                                   packed.reshape(-1)])
            got = _staged_model(flat, off, n, w, b, p)
            np.testing.assert_array_equal(got, codes)
            np.testing.assert_array_equal(
                ref.unpack_codes_ref(torch.from_numpy(packed), w=w,
                                     b=b).numpy(), codes)


@pytest.mark.parametrize("w", (1, 8, 16, 64))
def test_packed_rows_at_eight_bits_are_the_codes(w):
    """At b = 8 symbol j is byte j of the packed row, so unpack_mindist
    reads those rows in place as mindist_batch reads codes."""
    codes = np.random.default_rng(w).integers(0, 256, (257, w), np.uint8)
    packed = pack_codes(codes, 8)
    np.testing.assert_array_equal(packed, codes)
    np.testing.assert_array_equal(
        ref.unpack_codes_ref(torch.from_numpy(packed), w=w, b=8).numpy(),
        codes)
