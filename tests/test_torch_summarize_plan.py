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
search), also on PAAs that lie on breakpoints; and the key stage of
``csrc/key_stage.cuh`` (one ballot per bit plane, placed and bit-reversed,
where w is a power of two; ``row_key``'s plane accumulators, four codes at
a time, streamed out word by word, elsewhere) against ``ref.zorder_ref`` and
``core.keys.interleave_codes``.  ``tests/test_torch_zorder_plan.py`` runs
the same models over the ``zorder`` kernel's tiles.
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


def _brev(v):
    """__brev of 32-bit values (an int or a uint64 array)."""
    v = np.asarray(v, dtype=np.uint64)
    out = np.zeros_like(v)
    for k in range(32):
        out |= ((v >> np.uint64(k)) & np.uint64(1)) << np.uint64(31 - k)
    return out


def _byte_perm(x, y, sel):
    """__byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of the
    eight bytes of y:x (x's bytes first)."""
    out = np.zeros_like(x)
    for i in range(4):
        k = (sel >> (4 * i)) & 7
        src = x if k < 4 else y
        out |= ((src >> np.uint64(8 * (k & 3))) & np.uint64(0xFF)) \
            << np.uint64(8 * i)
    return out


def _ballot_keys_model(codes, w, b, rows, slots=False):
    """ballot_keys over tiles of ``rows`` rows, lane by lane as the kernel
    computes it, vectorized over the warps: pairs p = r * w + s of a tile,
    warp p // 32, lane p % 32; bal_i has bit l set when lane l's pair is
    live and bit b - 1 - i of its code is 1, for all 8 planes (the planes
    past b are zero).  ``slots``: at w = 16 and 8, the compile-time
    assembly (each candidate word gathered by byte permutes, the lane's
    picked) in place of the run-time one (each plane ORed where its word
    is the lane's)."""
    n = codes.shape[0]
    nw = K.n_key_words(w, b)
    lw = w.bit_length() - 1
    assert 1 << lw == w and (rows * w) % LANES == 0
    u = np.uint64
    full = u(0xFFFFFFFF)
    keys = np.full((n, nw), -1, dtype=np.int64)     # each word set once
    lane = np.arange(LANES)
    for row0 in range(0, n, rows):
        tr = min(rows, n - row0)
        live_pairs = tr * w
        pairs = np.zeros(rows * w, dtype=np.uint64)
        pairs[:live_pairs] = codes[row0:row0 + tr].reshape(-1)
        c = (pairs << u(32 - b)).reshape(-1, LANES)          # [warps, 32]
        bal = [((c >> u(31 - i)) & u(1)) << lane.astype(np.uint64)
               for i in range(8)]
        bal = [v.sum(axis=1, dtype=np.uint64) for v in bal]  # [warps]
        first = np.arange(0, rows * w, LANES)                 # p - lane
        if w <= LANES:
            row_mask = full >> u(LANES - w)
            for ln in range(LANES):
                g, kw = divmod(ln, nw)
                mine = g < LANES // w
                gw = u(g * w if mine else 0)
                t = np.zeros(len(first), dtype=np.uint64)
                perm = (0x5410 + 0x2222 * (g & 1) if w == 16
                        else 0x40 + 0x11 * (g & 3))
                if slots and w == 16:
                    cands = [_byte_perm(bal[2 * c], bal[2 * c + 1], perm)
                             for c in range(4)]
                    t = cands[kw] if kw < 4 else cands[0]
                elif slots and w == 8:
                    cands = [_byte_perm(
                        _byte_perm(bal[4 * c], bal[4 * c + 1], perm),
                        _byte_perm(bal[4 * c + 2], bal[4 * c + 3], perm),
                        0x5410) for c in range(2)]
                    t = cands[kw] if kw < 2 else cands[0]
                else:
                    for i in range(8):
                        bit0 = i * w
                        if bit0 >> 5 == kw:
                            t |= ((bal[i] >> gw) & row_mask) << u(bit0 & 31)
                row = (first >> lw) + g
                ok = mine & ((row << lw) < live_pairs)
                assert (keys[row0 + row[ok], kw] == -1).all()
                keys[row0 + row[ok], kw] = _brev(t[ok] & full)
        else:
            r = first >> lw
            h = (first & (w - 1)) >> 5
            ok = first < live_pairs
            for ln in range(b):          # lane i < b stores plane i
                assert (keys[row0 + r[ok], ln * (w >> 5) + h[ok]] == -1).all()
                keys[row0 + r[ok], ln * (w >> 5) + h[ok]] = _brev(bal[ln][ok])
    return keys


def _plane_nibble(x, sh):
    """plane_nibble: bit sh of four little-endian codes, MSB first."""
    x = np.asarray(x, dtype=np.uint64)
    return ((((x >> np.uint64(sh)) & np.uint64(0x01010101))
             * np.uint64(0x80402010)) & np.uint64(0xFFFFFFFF)) >> np.uint64(28)


def _row_key_model(code4, w, b, wide=False):
    """row_key for every row at once (each row runs the same steps): the
    key's bits appended in order to a 64-bit buffer, each word stored once
    it is whole, the last left-aligned.  Without ``wide`` (w <= 64) each
    group of four codes is read once into eight plane accumulators;
    ``wide`` streams plane by plane.  ``code4(j)`` gives each row's codes
    j .. j + 3 as a little-endian uint32.  Returns {word: values}, in the
    order stored."""
    u = np.uint64
    st = {"buf": u(0), "held": 0, "kw": 0, "out": {}}

    def append(v, n):
        st["buf"] = (st["buf"] << u(n)) | v
        st["held"] += n
        if st["held"] >= 32:
            st["held"] -= 32
            assert st["kw"] not in st["out"]
            st["out"][st["kw"]] = (st["buf"] >> u(st["held"])) & u(0xFFFFFFFF)
            st["kw"] += 1

    if not wide:
        assert w <= 64
        acc = [u(0)] * 8
        for j in range(0, w, 4):
            take = min(4, w - j)
            x = code4(j)
            for sh in range(8):
                acc[sh] = (acc[sh] << u(take)) | (_plane_nibble(x, sh)
                                                  >> u(4 - take))
        for sh in range(7, -1, -1):
            if sh < b:
                if w > 32:
                    append((acc[sh] >> u(32)) & u(0xFFFFFFFF), w - 32)
                append(acc[sh] & u(0xFFFFFFFF), min(w, 32))
    else:
        for sh in range(b - 1, -1, -1):
            for j in range(0, w, 4):
                take = min(4, w - j)
                append(_plane_nibble(code4(j), sh) >> u(4 - take), take)
    if st["held"]:
        st["out"][st["kw"]] = ((st["buf"] << u(32 - st["held"]))
                               & u(0xFFFFFFFF))
    return st["out"]


def _row_code4(codes):
    """code4 of the summarize tile's generic path: a row's codes read from
    device memory, four at a time, a code past the row read as 0."""
    w = codes.shape[1]
    padded = np.zeros((codes.shape[0], w + 3), dtype=np.uint64)
    padded[:, :w] = codes

    def code4(j):
        return sum(padded[:, j + e] << np.uint64(8 * e) for e in range(4))
    return code4


def _row_keys_model(codes, w, b, wide=False):
    """row_key over every row, from device memory: [n, nw] keys, every
    word stored once, in order."""
    nw = K.n_key_words(w, b)
    out = _row_key_model(_row_code4(codes), w, b, wide)
    assert list(out) == list(range(nw))
    return np.stack([np.broadcast_to(out[kw], (codes.shape[0],))
                     for kw in range(nw)], axis=1).astype(np.int64)


@pytest.mark.parametrize("b", range(1, 9))
def test_key_stage_model_matches_zorder(b):
    """Every w <= 64: ballot_keys where w is a power of two (both of its
    assemblies), row_key elsewhere; rows of a full tile, a partial tile
    and a single row; against the twin and interleave_codes."""
    rng = np.random.default_rng(b)
    for w in range(1, 65):
        rows = launch_plan(1, w).rows
        n = rows + rows // 2 + 1
        codes = rng.integers(0, 1 << b, (n, w), dtype=np.uint8)
        want = ref.zorder_ref(torch.from_numpy(codes), w=w, b=b).numpy()
        np.testing.assert_array_equal(
            K.interleave_codes(torch.from_numpy(codes), w=w, b=b).numpy(),
            want)
        if w & (w - 1) == 0:
            for slots in (False, True) if w in (8, 16) else (False,):
                np.testing.assert_array_equal(
                    _ballot_keys_model(codes, w, b, rows, slots), want,
                    err_msg=f"w={w} b={b} slots={slots}")
        else:
            np.testing.assert_array_equal(
                _row_keys_model(codes, w, b), want, err_msg=f"w={w} b={b}")


@pytest.mark.parametrize("w", (5, 12, 63, 64, 65, 96, 100, 300))
def test_wide_row_key_model_matches_zorder(w):
    """row_key's plane-by-plane path, which the generic tile takes past
    w = 64 (and which gives the same bits below it), every b."""
    rng = np.random.default_rng(w)
    for b in range(1, 9):
        codes = rng.integers(0, 1 << b, (7, w), dtype=np.uint8)
        want = ref.zorder_ref(torch.from_numpy(codes), w=w, b=b).numpy()
        np.testing.assert_array_equal(
            _row_keys_model(codes, w, b, wide=True), want,
            err_msg=f"w={w} b={b}")
