"""The launch plan of the cross form of ``batch_euclid``, checked on the CPU.

The wrapper (``repro_torch.kernels.batch_euclid``) computes the kernel's
launch in Python: the block's query tile (a block covers one warp tile's
``WARP_R`` rows, a warp per ``WARP_Q`` of its queries), the chunk of L
staged in shared memory and the grid; the kernel reads them from its
arguments.  These
tests hold the plan to what the kernel needs (every (query, row) pair
computed by exactly one lane, each lane's columns in increasing order, at
most the 48 KB of shared memory a block has without an opt-in, far under
the 232,448 bytes an H100 block can use) and check that shapes the kernel
does not take are refused.  A numpy model of the kernel's arithmetic (the
lane partials over the plan's chunks, then the register-tile fold by
shuffles) is held against the plain twin bit for bit: the tolerance is
none, since both do the same float32 operations in the same order.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import batch_euclid as be
from repro_torch.kernels import ref
from repro_torch.kernels.batch_euclid import (LANES, MAX_QTILE, SMEM_LIMIT,
                                              WARP_Q, WARP_R, launch_plan)

QS = (1, 7, 8, 9, 16, 17, 64, 100)
LS = (1, 31, 32, 33, 100, 256, 1024, 4096)
# every edge of one and of two row tiles, and a leaf and a bit
NS = (1, WARP_R - 1, WARP_R, WARP_R + 1, 2 * WARP_R - 1, 2 * WARP_R,
      2 * WARP_R + 1, 2037)
BLOCK_SMEM = 232_448      # shared memory one H100 block can use


def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("nq", QS)
def test_plan_fits_shared_memory_and_chunks_l(nq, L):
    for n in NS:
        p = launch_plan(nq, n, L)
        assert p.smem == (p.qtile + WARP_R) * p.lchunk * 4
        assert p.smem <= SMEM_LIMIT <= BLOCK_SMEM
        # chunks of whole 32-column steps, made equal, covering L once;
        # one chunk whenever all of L fits
        assert p.lchunk % LANES == 0 and p.lchunk >= LANES
        assert (p.chunks - 1) * p.lchunk < L <= p.chunks * p.lchunk
        assert p.chunks * p.lchunk - _ceil(L, LANES) * LANES < p.chunks * LANES
        whole = (p.qtile + WARP_R) * _ceil(L, LANES) * LANES * 4
        assert (p.chunks == 1) == (whole <= SMEM_LIMIT)
        assert p.qtile == min(MAX_QTILE, _ceil(nq, WARP_Q) * WARP_Q)
        assert 32 * (p.qtile // WARP_Q) <= 128     # the kernel's launch bounds
        assert p.grid == (_ceil(n, WARP_R), _ceil(nq, p.qtile))


def _pairs_of(p, nq, n):
    """Each (query, row) pair as the kernel computes it: block (bx, by)
    over rows bx * 8 ..., warp w over its queries w * 4 ..., lane l
    holding pair (l >> 3, l & 7) of the warp's 4 x 8 register tile after
    the fold; pairs past Q or N are not stored."""
    count = np.zeros((nq, n), dtype=np.int64)
    lanes = np.arange(32)
    for by in range(p.grid[1]):
        for bx in range(p.grid[0]):
            for w in range(p.qtile // WARP_Q):
                q = by * p.qtile + w * WARP_Q + (lanes >> 3)
                r = bx * WARP_R + (lanes & 7)
                ok = (q < nq) & (r < n)
                np.add.at(count, (q[ok], r[ok]), 1)
    return count


@pytest.mark.parametrize("nq", QS)
def test_plan_grid_covers_every_pair_once(nq):
    for n in NS:
        p = launch_plan(nq, n, 256)
        assert (_pairs_of(p, nq, n) == 1).all(), (nq, n, p)


@pytest.mark.parametrize("L", LS)
def test_plan_chunks_keep_each_lanes_order(L):
    """Lane l adds columns l, l + 32, l + 64, ... < L in that order over
    the chunks (the kernel runs min(lchunk, ceil32(L) - c0) / 32 steps of
    chunk c, and zero-filled columns past L add exactly 0)."""
    p = launch_plan(64, 2037, L)
    lpad = _ceil(L, LANES) * LANES
    for lane in range(32):
        cols = [c * p.lchunk + 32 * j + lane for c in range(p.chunks)
                for j in range(min(p.lchunk, lpad - c * p.lchunk) // 32)]
        assert cols == list(range(lane, lpad, 32))


def test_plan_main_path():
    """The dense verify launch (Q=64 x 1183 rows, L=256): 592 blocks of
    four warps, every multiprocessor busy, L in one chunk."""
    p = launch_plan(64, 1183, 256)
    assert p.grid[0] * p.grid[1] >= 132
    assert (p.qtile, p.chunks) == (16, 1)
    assert p.grid == (148, 4) and p.smem == 24_576
    # the median launch (175 rows) still spreads over 88 blocks
    assert launch_plan(64, 175, 256).grid == (22, 4)


def test_plan_few_queries_take_fewer_warps():
    """Q=1 (ops.batch_euclid, the TPU kernel's own shape): one warp per
    8-row block, 250 blocks over 2000 rows."""
    p = launch_plan(1, 2000, 256)
    assert (p.qtile, p.grid) == (4, (250, 1))
    assert launch_plan(7, 2000, 256).qtile == 8


def test_plan_cache_is_keyed_on_queries_and_length():
    """The eager batch's launches vary only in their row count: the cached
    part of the plan is one entry for all of them."""
    be._tiling.cache_clear()
    for n in range(1, 2001):
        assert launch_plan(64, n, 256).grid == (_ceil(n, WARP_R), 4)
    info = be._tiling.cache_info()
    assert (info.currsize, info.misses) == (1, 1)


@pytest.mark.parametrize("bad", [
    dict(nq=0), dict(n=0), dict(L=0), dict(n=2 ** 31),
    dict(nq=65_536 * MAX_QTILE)])
def test_plan_refuses_shapes_the_kernel_does_not_take(bad):
    args = dict(nq=64, n=1183, L=256)
    args.update(bad)
    with pytest.raises(ValueError):
        launch_plan(**args)


def _kernel_model(q, x, p):
    """The cross kernel's arithmetic for one 4 x 8 warp tile in float32:
    each lane's partials over the plan's chunks (zero padding past L),
    then the fold of the 32 partials of all 32 pairs by xor shuffles,
    lane l keeping one half of its values at each step."""
    f = np.float32
    L = q.shape[1]
    lpad = p.chunks * p.lchunk
    qp = np.zeros((4, lpad), f)
    xp = np.zeros((8, lpad), f)
    qp[:, :L], xp[:, :L] = q, x
    acc = np.zeros((32, 4, 8), f)                     # [lane, query, row]
    for c in range(p.chunks):
        for j in range(p.lchunk // 32):
            col = c * p.lchunk + 32 * j + np.arange(32)
            d = xp[None, :, col].transpose(2, 0, 1) - qp[:, col].T[:, :, None]
            with np.errstate(over="ignore"):          # 1e20 squared is inf
                acc = acc + d * d
    v = acc.reshape(32, 32)                           # [lane, value]
    lanes = np.arange(32)
    o = 16
    while o:
        up = (lanes & o) != 0
        send = np.where(up[:, None], v[:, :o], v[:, o:2 * o])
        keep = np.where(up[:, None], v[:, o:2 * o], v[:, :o])
        v = (keep + send[lanes ^ o]).astype(f)
        o //= 2
    return v[:, 0].reshape(4, 8)                      # lane l: (l >> 3, l & 7)


@pytest.mark.parametrize("L", LS)
def test_kernel_model_has_the_twins_bits(L):
    rng = np.random.default_rng(L)
    q = rng.standard_normal((4, L)).astype(np.float32)
    x = rng.standard_normal((8, L)).astype(np.float32)
    x[1] = q[2]                                       # a zero distance
    x[2] = 0.0
    x[3, ::3] = 1e20                                  # squares overflow
    q[3, 1::5] = -3e19
    got = _kernel_model(q, x, launch_plan(64, 2037, L))
    want = ref.batch_euclid_ref(torch.from_numpy(q), torch.from_numpy(x))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.numpy().view(np.uint32))
    assert got[2, 1] == 0 and np.isinf(got[:, 3]).all()
