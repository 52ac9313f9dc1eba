"""The launch plan and arithmetic of the summarize tile, checked on the CPU.

``sax_summarize`` and ``fused_build`` share one CUDA tile
(``csrc/summarize_tile.cuh``) whose launch is computed in Python by
``repro_torch.kernels.sax_summarize.launch_plan``: blocks of ``THREADS``
threads (the kernel's ``kSumThreads``), one (row, segment) pair each, so a
tile is ``THREADS // w`` whole rows, and a persistent grid in which block
``b`` walks tiles ``b, b + grid, ...``.  These tests hold the plan and the
kernel's constants, read from its source, to what the kernel needs (every
row summarized once; shared memory within the 48 KB a block has by
default; at the compile-time shapes, each thread's float4 loads are its own
segment, and a warp's loads read whole 32-byte sectors).

Numpy models of the kernel's arithmetic are held against the plain twins
bit for bit (the tolerance is none: both do the same float32 operations in
the same order): the PAA (the segment summed in index order from its first
float, then divided by its length) and the code (``sax_code``'s binary
search), also on PAAs that lie on breakpoints; and the key stage (one
ballot per bit plane, bit-reversed and shifted into place, or
``zorder_word`` at the other widths) against ``ref.zorder_ref`` and
``core.keys.interleave_codes``.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import INDEX
from repro_torch.core import keys as K
from repro_torch.core import summarization as S
from repro_torch.kernels import ref
from repro_torch.kernels import sax_summarize as sx
from repro_torch.kernels.sax_summarize import (BLOCKS_PER_SM, SMS, THREADS,
                                               launch_plan)

LANES = 32
SRC = (Path(sx.__file__).parent / "csrc" / "summarize_tile.cuh").read_text()
# the kernel's constants, as its source declares them
KC = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", SRC)}
# the (L, w) shapes with a compile-time tile, as the dispatcher names them
SHIPPED = sorted({(int(L), int(w)) for L, w in re.findall(
    r"a\.L == (\d+) && a\.w == (\d+)", SRC)})
F32 = np.float32
SECTOR = 32                # bytes of a device-memory sector


def _ceil(a, b):
    return -(-a // b)


def _row_counts(n, w):
    """How many times the kernel's tile walk summarizes each row."""
    p = launch_plan(n, w)
    tiles = _ceil(n, p.rows)
    walked = np.concatenate([np.arange(b, tiles, p.grid)
                             for b in range(p.grid)])
    rows = (walked[:, None] * p.rows + np.arange(p.rows)).ravel()
    return np.bincount(rows[rows < n], minlength=n)


def _edges(rows, grid):
    return (1, rows - 1, rows, rows + 1, 2 * rows - 1, 2 * rows + 1,
            rows * grid - 1, rows * grid, rows * grid + 1,
            rows * grid + rows + 1)


@pytest.mark.parametrize("w", (8, 16, 12, 64, 300))
def test_plan_covers_every_row_once(w):
    """N = 1, the edges of one and two tiles, of the persistent grid's
    first pass and of its wrap, and one external-sort chunk."""
    p = launch_plan(65_536, w)
    for n in sorted({max(1, v) for v in _edges(p.rows, SMS * BLOCKS_PER_SM)}
                    | {65_536}):
        assert (_row_counts(n, w) == 1).all(), (n, w)


def test_plan_covers_the_tree_build():
    """The paper deployment's 8,388,608 rows at w = 16."""
    assert (_row_counts(8_388_608, 16) == 1).all()


def test_plan_shape():
    """A tile is whole rows of one pair a thread (a row alone, its
    segments taken THREADS at a time, past THREADS segments), and the
    grid is one block a tile up to BLOCKS_PER_SM on each of the SMs."""
    assert THREADS == KC["kSumThreads"] and THREADS % LANES == 0
    assert BLOCKS_PER_SM == KC["kSumBlocksPerSm"]
    for w in (1, 7, 8, 12, 16, 64, 256, 257, 1024):
        for n in (1, 100, 65_536, 8_388_608):
            p = launch_plan(n, w)
            assert p.rows == (THREADS // w if w <= THREADS else 1)
            assert p.grid == min(_ceil(n, p.rows), SMS * BLOCKS_PER_SM)
    assert launch_plan(65_536, 16) == (16, 528)
    assert launch_plan(8_388_608, 16) == (16, 528)
    assert launch_plan(64, 8) == (32, 2)
    assert launch_plan.cache_info().maxsize is not None
    for n, w in ((0, 16), (10, 0)):
        with pytest.raises(ValueError):
            launch_plan(n, w)


def test_shipped_shapes_are_the_configs():
    """The compile-time tiles are the paper deployment's (256, 16) and the
    small (64, 8) configuration."""
    assert (INDEX.series_len, INDEX.segments) in SHIPPED
    assert SHIPPED == [(64, 8), (256, 16)]


def test_tile_fits_default_shared_memory():
    """The breakpoints are the kernel's only shared memory: static, far
    within 48 KB (no cudaFuncSetAttribute), at the widest b."""
    assert KC["kMaxBps"] == (1 << 8) - 1
    assert KC["kMaxBps"] * 4 <= 48 * 1024
    assert "extern __shared__" not in SRC


@pytest.mark.parametrize("L,w", SHIPPED)
def test_shaped_loads_are_each_threads_segment(L, w):
    """Thread tid of tile t reads float4s k = 0 .. sl / 4 - 1 at float
    (t * THREADS + tid) * sl + 4 k: its own segment, and no float past
    the last row; a warp's loads read each 32-byte sector of its span
    whole, and no sector twice."""
    sl = L // w
    rows = THREADS // w
    for n in (1, rows - 1, rows + 1, 3 * rows):
        seen = np.zeros(n * L, dtype=np.int64)
        for t in range(_ceil(n, rows)):
            for tid in range(THREADS):
                pair = t * THREADS + tid
                if pair >= n * w:
                    continue
                for k in range(sl // 4):
                    f0 = pair * sl + 4 * k
                    r, s = divmod(pair, w)
                    assert r * L + s * sl <= f0 < r * L + (s + 1) * sl
                    seen[f0:f0 + 4] += 1
        assert (seen == 1).all()
    warp = np.arange(LANES)
    sectors = np.concatenate([(warp * sl + 4 * k) * 4 // SECTOR
                              for k in range(sl // 4)])
    counts = np.bincount(sectors, minlength=LANES * sl * 4 // SECTOR)
    assert (counts == SECTOR // 16).all()


def _walks(rng, n, L):
    x = np.cumsum(rng.standard_normal((n, L)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(F32)


def _paa_model(x, w):
    """The tile's PAA: each segment summed in index order from its first
    float, one float32 rounding per add, then divided by its length."""
    n, L = x.shape
    sl = L // w
    seg = x.reshape(n, w, sl)
    acc = seg[..., 0].copy()
    for e in range(1, sl):
        acc = (acc + seg[..., e]).astype(F32)
    return (acc / F32(sl)).astype(F32)


def _code_model(v, bps):
    """sax_code: a branch-free binary search, pos += step while
    bps[pos + step - 1] <= v, for steps card / 2 .. 1."""
    pos = np.zeros(v.shape, dtype=np.int64)
    step = (len(bps) + 1) >> 1
    while step:
        pos += np.where(bps[pos + step - 1] <= v, step, 0)
        step >>= 1
    return pos


@pytest.mark.parametrize("b", (1, 3, 4, 8))
@pytest.mark.parametrize("L,w", SHIPPED + [(60, 12), (300, 12), (256, 64)])
def test_paa_and_code_model_match_the_twin(L, w, b):
    """Random walks, and segments built so that their PAA is a breakpoint
    exactly or one float from it (a code decided by <=)."""
    rng = np.random.default_rng(L * w + b)
    sl = L // w
    bps = S.breakpoints(b).numpy()
    x = _walks(rng, 97, L)
    on = np.zeros((3 * len(bps), w, sl), dtype=F32)
    for i, bp in enumerate(bps):
        for d, v in enumerate((bp, np.nextafter(bp, F32(-1e9)),
                               np.nextafter(bp, F32(1e9)))):
            if sl & (sl - 1) == 0:          # v * sl is exact
                on[3 * i + d, :, 0] = v * F32(sl)
            else:
                on[3 * i + d] = v
    x = np.concatenate([x, on.reshape(len(on), L)])
    paa = _paa_model(x, w)
    codes = _code_model(paa, bps)
    r_paa, r_codes = ref.sax_summarize_ref(torch.from_numpy(x),
                                           torch.from_numpy(bps), segments=w)
    np.testing.assert_array_equal(paa.view(np.int32),
                                  r_paa.numpy().view(np.int32))
    np.testing.assert_array_equal(codes, r_codes.numpy())
    if sl & (sl - 1) == 0:
        hit = paa[97:].reshape(len(bps), 3, w)[:, 0, 0]
        np.testing.assert_array_equal(hit, bps)     # PAAs on breakpoints


def _brev(v: int) -> int:
    """__brev of a 32-bit value."""
    return int(f"{v:032b}"[::-1], 2)


def _ballot_keys_model(codes, w, b):
    """ballot_keys over a launch, lane by lane as the kernel computes it:
    pairs p = r * w + s of each tile, lane p % 32; bal_i has bit l set when
    lane l's pair is live and bit b - 1 - i of its code is 1."""
    n = codes.shape[0]
    nw = K.n_key_words(w, b)
    rows = launch_plan(n, w).rows
    keys = np.full((n, nw), -1, dtype=np.int64)     # each word set once
    full = 0xFFFFFFFF
    for row0 in range(0, n, rows):
        tr = min(rows, n - row0)
        live_pairs = tr * w
        flat = [int(c) for c in codes[row0:row0 + tr].reshape(-1)]
        for p0 in range(0, rows * w, THREADS):
            for first in range(p0, p0 + THREADS, LANES):
                live = [first + ln < live_pairs for ln in range(LANES)]
                code = [flat[first + ln] if live[ln] else 0
                        for ln in range(LANES)]
                bal = [sum(((code[ln] >> (b - 1 - i)) & 1) << ln
                           for ln in range(LANES) if live[ln])
                       for i in range(b)]
                if w <= LANES:
                    r0 = first // w
                    for ln in range(LANES):
                        g, kw = divmod(ln, nw)
                        if g >= LANES // w:
                            continue
                        word = 0
                        for i in range(b):
                            bit0 = i * w
                            if bit0 >> 5 != kw:
                                continue
                            f = (bal[i] >> (g * w)) & (full >> (LANES - w))
                            word |= ((_brev(f) >> (LANES - w))
                                     << (LANES - w - (bit0 & 31))) & full
                        if (r0 + g) * w < live_pairs:
                            assert keys[row0 + r0 + g, kw] == -1
                            keys[row0 + r0 + g, kw] = word
                elif live[0]:
                    r, s = divmod(first, w)
                    for i in range(b):
                        kw = i * (w // LANES) + s // LANES
                        assert keys[row0 + r, kw] == -1
                        keys[row0 + r, kw] = _brev(bal[i])
    return keys


def _zorder_word_model(codes, w, b):
    """zorder_word: global bit p = i * w + j (MSB first) of word p // 32."""
    n = codes.shape[0]
    nw = K.n_key_words(w, b)
    keys = np.zeros((n, nw), dtype=np.int64)
    for kw in range(nw):
        for bit in range(32):
            p = kw * 32 + bit
            if p >= w * b:
                break
            i, j = divmod(p, w)
            keys[:, kw] |= ((codes[:, j].astype(np.int64) >> (b - 1 - i))
                            & 1) << (31 - bit)
    return keys


@pytest.mark.parametrize("b", range(1, 9))
def test_key_stage_model_matches_zorder(b):
    """Every w <= 64: the ballot stage where w divides 32 or is a multiple
    of it, zorder_word elsewhere; rows of a full tile, a partial tile and a
    single row; against the twin and interleave_codes."""
    rng = np.random.default_rng(b)
    for w in range(1, 65):
        rows = launch_plan(1, w).rows
        n = rows + rows // 2 + 1
        codes = rng.integers(0, 1 << b, (n, w), dtype=np.uint8)
        want = ref.zorder_ref(torch.from_numpy(codes), w=w, b=b).numpy()
        np.testing.assert_array_equal(
            K.interleave_codes(torch.from_numpy(codes), w=w, b=b).numpy(),
            want)
        if 32 % w == 0 or w % 32 == 0:
            got = _ballot_keys_model(codes, w, b)
        else:
            got = _zorder_word_model(codes, w, b)
        np.testing.assert_array_equal(got, want, err_msg=f"w={w} b={b}")
