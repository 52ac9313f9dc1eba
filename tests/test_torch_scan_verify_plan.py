"""The launch plan of the ``scan_verify`` kernel, checked on the CPU.

The wrapper (``repro_torch.kernels.scan_verify``) computes the kernel's
launch in Python: rows per tile, queries per shared-memory chunk, grid,
the block's shared-memory regions and the list bytes; the kernel takes the
regions' offsets from it.  These tests hold that plan to what the kernel
needs (at most 232,448 bytes of shared memory per block on an H100,
regions 16-byte aligned and disjoint, every row and every query covered,
the grid within the fold's 128 blocks) and check that shapes the kernel
does not take are refused.  Also here: the (distance bits, row) key the kernel selects by
orders pairs as the plain twin's stable sort does.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.scan_verify import (FOLD_SCRATCH, MAX_GRID,
                                             REGIONS, SMEM_LIMIT,
                                             WORKSPACE_LIMIT, launch_plan,
                                             list_bytes, smem_layout)


@pytest.mark.parametrize("L", (64, 256, 1024, 2048))
@pytest.mark.parametrize("nq", (1, 8, 64, 100, 256))
def test_plan_fits_and_covers(nq, L):
    for n in (1, 257, 2000, 2037, 8_388_608):
        for w in (8, 16, 64):
            for k in (1, 10, 64):
                p = launch_plan(nq, n, L, w, k, 256)
                assert p.smem == smem_layout(p.qchunk, p.tile, L, w, k, 256,
                                             p.grid).bytes
                assert p.smem <= SMEM_LIMIT
                # every query in exactly one chunk, no empty chunk
                assert 1 <= p.qchunk <= nq
                assert p.chunks * p.qchunk >= nq
                assert (p.chunks - 1) * p.qchunk < nq
                # every row in one tile; blocks stride over the tiles
                tiles = -(-n // p.tile)
                assert 1 <= p.tile <= 64 and tiles * p.tile >= n
                assert 1 <= p.grid <= min(MAX_GRID, tiles)
                assert p.lists == list_bytes(p.grid, nq, k)
                assert p.lists <= WORKSPACE_LIMIT


@pytest.mark.parametrize("L", (64, 256, 1024, 2048))
@pytest.mark.parametrize("nq", (1, 8, 64, 100, 256))
def test_plan_regions_are_aligned_and_disjoint(nq, L):
    """The offsets handed to the kernel: one per region, in the kernel's
    order, each 16-byte aligned and past the end of the one before, the
    last ending within the block's bytes, which also hold the fold."""
    for w, k in ((8, 1), (16, 10), (64, 64)):
        for n in (1, 2037):
            p = launch_plan(nq, n, L, w, k, 256)
            lay = smem_layout(p.qchunk, p.tile, L, w, k, 256, p.grid)
            assert p.offsets == lay.offsets
            assert len(lay.offsets) == len(lay.sizes) == len(REGIONS)
            ends = [o + b for o, b in zip(lay.offsets, lay.sizes)]
            assert all(o % 16 == 0 for o in lay.offsets)
            assert all(e <= o for e, o in zip(ends, lay.offsets[1:]))
            assert ends[-1] <= p.smem
            assert p.smem >= p.grid * 9 + FOLD_SCRATCH + 32
            assert lay.sizes[REGIONS.index("q")] == p.qchunk * L * 4


def test_plan_main_path():
    """Q=64 queries against one 2000-row leaf (L=256, w=16, k=10): one
    query chunk and a grid of 16-row tiles that covers the 132 SMs."""
    p = launch_plan(64, 2000, 256, 16, 10, 256)
    assert (p.tile, p.chunks, p.qchunk, p.grid) == (16, 1, 64, 125)
    # two blocks' shared memory fit one SM's 228 KB
    assert 2 * p.smem <= 228 * 1024


def test_plan_chunks_queries_that_do_not_fit():
    p = launch_plan(64, 2037, 1024, 16, 10, 256)
    assert p.chunks > 1
    assert smem_layout(64, p.tile, 1024, 16, 10, 256,
                       p.grid).bytes > SMEM_LIMIT


def test_plan_follows_the_multiprocessor_count():
    assert launch_plan(64, 2000, 256, 16, 10, 256, sms=66).grid == 63
    assert launch_plan(64, 2000, 256, 16, 10, 256, sms=264).grid == 128


@pytest.mark.parametrize("bad", [
    dict(k=0), dict(k=65), dict(w=0), dict(w=65), dict(n=0),
    dict(n=2 ** 31), dict(nq=0), dict(L=0), dict(L=1 << 20)])
def test_plan_refuses_shapes_the_kernel_does_not_take(bad):
    args = dict(nq=64, n=2000, L=256, w=16, k=10, card=256)
    args.update(bad)
    with pytest.raises(ValueError):
        launch_plan(**args)


def test_pair_keys_order_as_the_twins_stable_sort():
    """(float bits of d) << 32 | row, compared as unsigned 64-bit keys,
    orders (query, row) pairs by distance and then lowest row: the order of
    scan_verify_ref's stable sort, ties and +inf included."""
    rng = np.random.default_rng(0)
    d = rng.choice(np.array([0.0, 1.5, 2.25, 7.0, np.inf], np.float32),
                   size=(8, 300))
    d[:, ::7] = rng.random((8, 43), dtype=np.float32)
    keys = ((d.view(np.uint32).astype(np.uint64) << np.uint64(32))
            | np.arange(300, dtype=np.uint64)[None, :])
    by_key = np.argsort(keys, axis=1, kind="stable")
    twin = torch.sort(torch.from_numpy(d), dim=1, stable=True).indices
    np.testing.assert_array_equal(by_key, twin.numpy())


def test_twin_pads_with_inf_and_minus_one():
    """What the kernel must write when fewer than k pairs are live."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 64, generator=g)
    x = torch.randn(50, 64, generator=g)
    q_paas = q.reshape(4, 8, 8).mean(-1)
    codes = torch.zeros(50, 8, dtype=torch.uint8)
    lower = torch.full((2,), -float("inf"))
    upper = torch.full((2,), float("inf"))
    bound = torch.tensor([0.0, 1.0, 0.0, 1.0])   # md is 0: < 1 is live
    d, i, c, u = ref.scan_verify_ref(q, q_paas, codes, x, lower, upper,
                                     bound, torch.zeros(50, dtype=torch.int32),
                                     scale=8.0, k=10)
    assert torch.isinf(d[0]).all() and (i[0] == -1).all()
    assert torch.isfinite(d[1]).all() and (i[1] >= 0).all()
    assert c.tolist() == [0, 50, 0, 50] and int(u) == 50
