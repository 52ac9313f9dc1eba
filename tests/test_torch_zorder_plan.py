"""The launch plan and key stage of the ``zorder`` kernel, checked on the CPU.

``csrc/zorder.cu`` walks tiles of whole rows on a persistent grid whose
launch is computed in Python by ``repro_torch.kernels.zorder.launch_plan``:
blocks of ``THREADS`` threads (the kernel's ``kZThreads``), each thread
loading ``VEC`` codes of a tile, block ``b`` taking tiles ``b, b + grid,
...``.  These tests hold the plan and the kernel's constants, read from its
source, to what the kernel needs: every row keyed once, each code byte
loaded once and none past the array, every tile 16-byte aligned, the C
entry point's checks met, shared memory within the 48 KB a block has by
default.

The key stage (``csrc/key_stage.cuh``) is run over the kernel's tiles by
the numpy models of ``tests/test_torch_summarize_plan.py``, lane by lane as
the kernel computes it: ``ballot_keys`` where w is a power of two (its tile
is ``VEC`` rounds of the summarize tile's layout), ``row_key`` from the
tile's codes in shared memory elsewhere, a thread a row.  Each is held against ``ref.zorder_ref`` and
``core.keys.interleave_codes`` bit for bit (the tolerance is none: keys are
integers).
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import keys as K
from repro_torch.kernels import ref
from repro_torch.kernels import zorder as zo
from repro_torch.kernels.zorder import (BLOCKS_PER_SM, SMS, THREADS, VEC,
                                        launch_plan)
from test_torch_summarize_plan import (_ballot_keys_model, _plane_nibble,
                                       _row_key_model)

SRC = (Path(zo.__file__).parent / "csrc" / "zorder.cu").read_text()
# the kernel's constants, as its source declares them
KC = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", SRC)}
NS = (1, 31, 65_536, 8_388_608)
WS = tuple(range(1, 65))


def _ceil(a, b):
    return -(-a // b)


def _tile_counts(n, w):
    """How many times the persistent grid's walk takes each tile."""
    p = launch_plan(n, w)
    tiles = _ceil(n, p.rows)
    walked = np.concatenate([np.arange(b, tiles, p.grid)
                             for b in range(p.grid)])
    return np.bincount(walked, minlength=tiles), p


@pytest.mark.parametrize("w", WS)
def test_plan_covers_every_row_once(w):
    """One row, a ragged 31, one external-sort chunk and the tree build:
    the walk takes each tile once, and the tiles (rows t * rows ..
    t * rows + rows - 1, cut at n) hold each row once."""
    for n in NS:
        counts, p = _tile_counts(n, w)
        assert (counts == 1).all(), (n, w)
        assert 1 <= p.grid <= SMS * BLOCKS_PER_SM
        assert len(counts) * p.rows >= n > (len(counts) - 1) * p.rows
        if n < 100_000:
            rows = (np.arange(len(counts))[:, None] * p.rows
                    + np.arange(p.rows)).ravel()
            hits = np.bincount(rows[rows < n], minlength=n)
            assert (hits == 1).all(), (n, w)


def _entry_accepts(n, w, b, rows, grid):
    """coconut_zorder's checks (csrc/zorder.cu), before any launch."""
    tile = KC["kZVec"] * KC["kZThreads"]
    pow2 = w & (w - 1) == 0
    return (n >= 1 and 1 <= w <= 64 and 1 <= b <= 8 and rows >= 1
            and rows * w <= tile and (not pow2 or rows * w == tile)
            and rows * w % 16 == 0 and grid >= 1)


def test_plan_shape():
    """The constants agree with the kernel's; a tile is exactly THREADS *
    VEC codes where w is a power of two, else the most whole rows that
    fit in a multiple of 16 bytes (at most THREADS rows); the grid is one
    block a tile up to BLOCKS_PER_SM on each SM; the C entry point takes
    every plan."""
    assert THREADS == KC["kZThreads"] and THREADS % 32 == 0
    assert VEC == KC["kZVec"] == 16
    assert BLOCKS_PER_SM == KC["kZBlocksPerSm"]
    tile = THREADS * VEC
    for w in WS:
        for n in NS:
            p = launch_plan(n, w)
            assert p.grid == min(_ceil(n, p.rows), SMS * BLOCKS_PER_SM)
            step = 16 // math.gcd(w, 16)
            assert p.rows % step == 0
            if w & (w - 1) == 0:
                assert p.rows * w == tile
            else:       # a thread a row: at most THREADS rows
                most = min(tile // w, THREADS)
                assert most - step < p.rows <= most
            for b in range(1, 9):
                assert _entry_accepts(n, w, b, p.rows, p.grid)
    assert launch_plan(65_536, 16) == (256, 256)
    assert launch_plan(8_388_608, 16) == (256, 528)
    assert launch_plan(8_388_608, 12) == (256, 528)
    assert launch_plan(64, 16) == (256, 1)              # the seed probe
    assert launch_plan.cache_info().maxsize is not None
    for n, w in ((0, 16), (10, 0), (10, 65)):
        with pytest.raises(ValueError):
            launch_plan(n, w)


def test_shared_memory_fits_default():
    """Two code buffers of a full tile and its pad: static, within 48 KB
    (no cudaFuncSetAttribute)."""
    smem = 2 * (KC["kZVec"] * KC["kZThreads"] + 16)
    assert smem <= 48 * 1024
    assert "extern __shared__" not in SRC
    assert "cudaFuncSetAttribute" not in SRC


@pytest.mark.parametrize("w", (1, 3, 12, 16, 63, 64))
def test_loads_cover_each_code_once(w):
    """Thread t of tile T loads bytes T * rows * w + 16 t .. + 15, cut
    at n * w: each code byte once, none past the array; every tile, so
    every whole load, starts 16-byte aligned."""
    for n in (1, 31, 1000):
        p = launch_plan(n, w)
        total = n * w
        seen = np.zeros(total, dtype=np.int64)
        for t in range(_ceil(n, p.rows)):
            tb = t * p.rows * w
            assert tb % 16 == 0
            for tid in range(THREADS):
                left = min(p.rows * w, total - tb) - VEC * tid
                lo = tb + VEC * tid
                seen[lo:lo + max(0, min(VEC, left))] += 1
        assert (seen == 1).all(), (n, w)


@pytest.mark.parametrize("w", [w for w in WS if w & (w - 1)])
def test_row_key_stores_each_word_once(w):
    """row_key stores words 0 .. nw - 1 in order, once each, at every b:
    its appends of w bits a plane (in parts of at most 32) fill the
    64-bit buffer with no more than 32 + 32 bits."""
    for b in range(1, 9):
        out = _row_key_model(lambda j: np.zeros(1, dtype=np.uint64), w, b)
        assert list(out) == list(range(K.n_key_words(w, b)))


def test_plane_nibble_gathers_one_plane():
    """plane_nibble(x, sh) is bit sh of bytes 0, 1, 2, 3 of x, MSB first."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, 20_000, dtype=np.uint64)
    for sh in range(8):
        want = sum(((x >> np.uint64(8 * k + sh)) & np.uint64(1))
                   << np.uint64(3 - k) for k in range(4))
        np.testing.assert_array_equal(_plane_nibble(x, sh), want)


def _zorder_rows_model(codes, w, b):
    """The kernel's row_key tiles: each tile's codes in a shared buffer of
    VEC * THREADS bytes and its pad (zero past the tile's live codes),
    read four at a time from any byte offset; row r starts at byte r * w."""
    n = codes.shape[0]
    nw = K.n_key_words(w, b)
    p = launch_plan(n, w)
    assert p.rows <= THREADS
    keys = np.full((n, nw), -1, dtype=np.int64)
    size = VEC * THREADS + 16
    for row0 in range(0, n, p.rows):
        tr = min(p.rows, n - row0)
        buf = np.zeros(size, dtype=np.uint64)
        buf[:tr * w] = codes[row0:row0 + tr].reshape(-1)
        base = np.arange(tr) * w

        def code4(j):
            o = base + j
            return sum(buf[o + e] << np.uint64(8 * e) for e in range(4))
        out = _row_key_model(code4, w, b)
        assert list(out) == list(range(nw))
        for kw in range(nw):
            keys[row0:row0 + tr, kw] = out[kw]
    return keys


def _cases(rng, w, b, rows):
    """A full tile and a partial one (with a code of bit b - 1 set in
    segment 0 at the first row, the word's top bit), and a single row."""
    n = rows + rows // 2 + 1
    codes = rng.integers(0, 1 << b, (n, w), dtype=np.uint8)
    codes[0, 0] = (1 << b) - 1
    return codes, codes[:1]


@pytest.mark.parametrize("b", range(1, 9))
def test_row_key_model_matches_zorder(b):
    """Every w <= 64 that is not a power of two: the kernel's tiles of
    row_key equal the twin and interleave_codes."""
    rng = np.random.default_rng(100 + b)
    for w in WS:
        if w & (w - 1) == 0:
            continue
        for codes in _cases(rng, w, b, launch_plan(1, w).rows):
            want = ref.zorder_ref(torch.from_numpy(codes), w=w, b=b).numpy()
            np.testing.assert_array_equal(
                K.interleave_codes(torch.from_numpy(codes), w=w,
                                   b=b).numpy(), want)
            np.testing.assert_array_equal(
                _zorder_rows_model(codes, w, b), want,
                err_msg=f"w={w} b={b} n={len(codes)}")
            assert (want >= 0).all() and (want < 1 << 32).all()


@pytest.mark.parametrize("b", range(1, 9))
def test_ballot_model_over_zorder_tiles(b):
    """w = 1, 2, 4, 8, 16, 32, 64 over the kernel's tiles (VEC rounds of
    the summarize tile's layout: pair k * THREADS + t in round k), at 8
    and 16 both assemblies: the twin's bits, every word set once."""
    rng = np.random.default_rng(200 + b)
    for lw in range(7):
        w = 1 << lw
        rows = launch_plan(1, w).rows
        for codes in _cases(rng, w, b, rows):
            want = ref.zorder_ref(torch.from_numpy(codes), w=w, b=b).numpy()
            for slots in (False, True) if w in (8, 16) else (False,):
                np.testing.assert_array_equal(
                    _ballot_keys_model(codes, w, b, rows, slots), want,
                    err_msg=f"w={w} b={b} slots={slots}")


def test_top_bit_words_are_zero_extended():
    """Code 128 in segment 0 (b = 8) sets bit 31 of word 0 and no other: the
    int64-held word is 2^31 or more, never negative (zero-extended)."""
    for w in (16, 12, 64):
        codes = np.zeros((3, w), dtype=np.uint8)
        codes[:, 0] = 128
        want = ref.zorder_ref(torch.from_numpy(codes), w=w, b=8).numpy()
        assert (want[:, 0] == 1 << 31).all()
        rows = launch_plan(3, w).rows
        got = (_ballot_keys_model(codes, w, 8, rows) if w & (w - 1) == 0
               else _zorder_rows_model(codes, w, 8))
        np.testing.assert_array_equal(got, want)
