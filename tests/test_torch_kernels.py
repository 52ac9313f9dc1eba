"""CUDA sweeps of the port's hand-written kernels against their plain twins.

Every test needs a CUDA device and skips without one (the ``cuda`` fixture
decides at run time).  On the card each kernel is held against its twin in
``repro_torch.kernels.ref`` on the same CUDA tensors, and against the twin on
the CPU.  Tolerance: none — kernels and twins perform the same float32
operations in the same order with no fused multiply-add (see
``csrc/common.cuh``), so floats must agree bit for bit; ints exactly.
Shapes: N not a multiple of any block, Q in {1, 8, 64}, b in {1, 4, 8},
k in {1, 10}; the construction and packed-bound kernels also at b in
{3, 5}, where packed symbols straddle bytes; the cross form of
``batch_euclid`` at every tile edge of its launch plan, L up to 4096; the
bound tile of ``mindist_batch`` and ``unpack_mindist`` at every tile edge
of its plan, w in {8, 16, 64}, every b, at every byte offset; the
summarize tile of ``sax_summarize`` and ``fused_build`` at every tile
edge and the persistent grid's wrap, its compile-time and generic shapes
(w dividing 32, a multiple of 32, neither; L up to 60,000), at every
4-byte offset; ``zorder`` at every w <= 64 (its ballot widths, compile-time
and not, and its run_word widths), b in {1, 3, 5, 8}, N at one row, a
ragged 31, one past a tile and one past a chunk, from row slices that are
not 16-byte aligned, words with their top bit set.  Cross-kernel identities:
``sax_summarize`` + ``zorder`` == ``fused_build`` and ``unpack_mindist``
== ``mindist_batch`` on the decoded codes, bit for bit.
``chip_smoke.py``'s kernel phase runs the same checks.  Beside them,
``pool_merge`` against its twin over four folds in turn, k up to 256, and
the exact loop over 2^23 rows with every synchronizing call an error.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import summarization as S
from repro_torch.kernels import loader, ops, ref
from repro_torch.kernels.batch_euclid import WARP_R
from repro_torch.kernels.mindist_batch import ROWS as MD_ROWS
from repro_torch.kernels.sax_summarize import BLOCKS_PER_SM as SUM_BLOCKS_PER_SM
from repro_torch.kernels.sax_summarize import SMS as SUM_SMS
from repro_torch.kernels.sax_summarize import launch_plan as sum_plan
from repro_torch.kernels.scan_verify import launch_plan
from repro_torch.kernels.zorder import launch_plan as zorder_plan
from repro_torch.storage.packing import pack_codes

NS = (1, 257, 2000 + 37)
QS = (1, 8, 64)
BITS = (1, 4, 8)
CFGS = {b: [S.SummaryConfig(64, 8, b), S.SummaryConfig(256, 16, b)]
        for b in BITS}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    loader.library()
    return torch.device("cuda")


def _walks(rng, n, L):
    x = np.cumsum(rng.standard_normal((n, L)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


def _inputs(seed, n, nq, cfg, dev):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_walks(rng, n, cfg.series_len))
    q = torch.from_numpy(_walks(rng, nq, cfg.series_len))
    paa, codes = S.summarize(x, cfg)
    q_paas = S.paa(q, cfg.segments)
    return {k: v.to(dev) for k, v in
            dict(x=x, q=q, codes=codes, paa=paa, q_paas=q_paas).items()}


def _same(a, b):
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("b", BITS)
@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("n", NS)
def test_mindist_batch_kernel(cuda, n, nq, b):
    for cfg in CFGS[b]:
        t = _inputs(n + nq + b, n, nq, cfg, cuda)
        got = ops.mindist_batch(t["q_paas"], t["codes"], cfg)
        torch.cuda.synchronize()
        lower, upper = S.region_bounds(b, device=cuda)
        scale = cfg.series_len / cfg.segments
        _same(got, ref.mindist_batch_ref(t["q_paas"], t["codes"], lower,
                                         upper, scale))
        _same(got, ops.mindist_batch(t["q_paas"].cpu(), t["codes"].cpu(),
                                     cfg))
        _same(ops.mindist(t["q_paas"][0], t["codes"], cfg), got[0])


def test_mindist_batch_kernel_unaligned_codes(cuda):
    """A codes view that is not 16-byte aligned takes the byte-wise path."""
    cfg = S.SummaryConfig(256, 16, 8)
    t = _inputs(7, 300, 8, cfg, cuda)
    view = t["codes"][1:]
    got = ops.mindist_batch(t["q_paas"], view, cfg)
    _same(got, ops.mindist_batch(t["q_paas"].cpu(), view.cpu(), cfg))


@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("n", NS)
def test_batch_euclid_kernel(cuda, n, nq):
    for L in (64, 256, 100):
        cfg = S.SummaryConfig(L, 4, 4)
        t = _inputs(n * nq + L, n, nq, cfg, cuda)
        got = ops.batch_euclid_multi(t["q"], t["x"])
        torch.cuda.synchronize()
        _same(got, ref.batch_euclid_ref(t["q"], t["x"]))
        _same(got, ops.batch_euclid_multi(t["q"].cpu(), t["x"].cpu()))
        # gathered form: the same pairs give the same bits
        rng = np.random.default_rng(n)
        idx = torch.from_numpy(rng.integers(0, n, (nq, 33))).to(cuda)
        gat = ops.batch_euclid_multi(t["q"], t["x"], idx=idx)
        torch.cuda.synchronize()
        _same(gat, torch.gather(got, 1, idx))
        _same(ops.batch_euclid(t["q"][0], t["x"]), got[0])


# the cross form's launch plan: N at every edge of one and two row tiles,
# Q across the 4-query warp tile and the 16-query block tile, L across the
# 32-lane steps and the shared-memory chunks (L >= 1024 takes several)
CROSS_NS = (1, WARP_R - 1, WARP_R, WARP_R + 1, 2 * WARP_R - 1, 2 * WARP_R,
            2 * WARP_R + 1, 2037)
CROSS_QS = (1, 7, 8, 9, 16, 17, 64, 100)
CROSS_LS = (1, 31, 32, 33, 100, 256, 1024, 4096)


def _cross_same_as_twin(q, x):
    """The cross form on the card == its twin on the card and on the CPU,
    bit for bit; returns the card's output."""
    got = ops.batch_euclid_multi(q, x)
    torch.cuda.synchronize()
    _same(got, ref.batch_euclid_ref(q, x))
    _same(got, ops.batch_euclid_multi(q.cpu(), x.cpu()))
    return got


def _normal(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("L", CROSS_LS)
@pytest.mark.parametrize("nq", CROSS_QS)
def test_batch_euclid_cross_tile_edges(cuda, nq, L):
    rng = np.random.default_rng(nq * 10_000 + L)
    q = _normal(rng, nq, L).to(cuda)
    for n in CROSS_NS:
        x = _normal(rng, n, L).to(cuda)
        got = _cross_same_as_twin(q, x)
        # the gathered form gives the same pairs the same bits, and
        # ops.batch_euclid (Q = 1) is row 0
        idx = torch.from_numpy(rng.integers(0, n, (nq, 33))).to(cuda)
        _same(ops.batch_euclid_multi(q, x, idx=idx), torch.gather(got, 1, idx))
        _same(ops.batch_euclid(q[0], x), got[0])


def test_batch_euclid_cross_repeatable(cuda):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_walks(rng, 64, 256)).to(cuda)
    x = torch.from_numpy(_walks(rng, 1183, 256)).to(cuda)
    first = _cross_same_as_twin(q, x)
    for _ in range(20):
        _same(ops.batch_euclid_multi(q, x), first)


@pytest.mark.parametrize("L", (33, 256, 1024))
def test_batch_euclid_cross_extreme_inputs(cuda, L):
    """Zeros, rows equal to queries (distance 0) and magnitudes whose
    squares overflow to inf, as the twin's do."""
    rng = np.random.default_rng(L)
    q = _normal(rng, 17, L)
    x = _normal(rng, 301, L)
    x[17:40] = 0.0
    q[5] = 0.0
    x[40:60, ::3] = 1e20
    q[7, 1::5] = -3e19
    x[60:70] = 1e20
    q[8] = -1e20
    x[:17] = q
    got = _cross_same_as_twin(q.to(cuda), x.to(cuda))
    assert (got[:, :17].diagonal() == 0).all()
    assert torch.isinf(got[:, 40:60]).all() and torch.isinf(got[8, 60:70]).all()


def test_batch_euclid_cross_unaligned_rows(cuda):
    """Queries and rows that are not 16-byte aligned take 4-byte copies."""
    rng = np.random.default_rng(9)
    flat_x = _normal(rng, 300 * 256 + 1).to(cuda)
    flat_q = _normal(rng, 17 * 256 + 3).to(cuda)
    x = flat_x[1:].view(300, 256)
    q = flat_q[3:].view(17, 256)
    got = _cross_same_as_twin(q, x)
    _same(got, _cross_same_as_twin(q.clone(), x.clone()))


@pytest.mark.parametrize("k", (1, 10))
@pytest.mark.parametrize("b", BITS)
@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("n", NS)
def test_scan_verify_kernel(cuda, n, nq, b, k):
    for cfg in CFGS[b]:
        t = _inputs(n + 3 * nq + b + k, n, nq, cfg, cuda)
        k_eff = min(k, n)
        ed = ops.batch_euclid_multi(t["q"], t["x"])
        # a bound that keeps roughly half the rows per query
        bound = ed.median(dim=1).values
        dead = torch.from_numpy(
            np.random.default_rng(n).random(n) < 0.2).to(cuda)
        for dd in (None, dead):
            got = ops.scan_verify(t["q"], t["q_paas"], t["codes"], t["x"],
                                  bound, cfg, k=k_eff, dead=dd)
            torch.cuda.synchronize()
            cpu = ops.scan_verify(t["q"].cpu(), t["q_paas"].cpu(),
                                  t["codes"].cpu(), t["x"].cpu(),
                                  bound.cpu(), cfg, k=k_eff,
                                  dead=None if dd is None else dd.cpu())
            for a, c in zip(got, cpu):
                _same(a, c)


def test_scan_verify_ties_go_to_lowest_row(cuda):
    cfg = S.SummaryConfig(64, 8, 4)
    t = _inputs(3, 600, 8, cfg, cuda)
    x = t["x"].clone()
    x[300:600] = x[0:300]          # every row has an exact twin later on
    paa, codes = S.summarize(x, cfg)
    bound = torch.full((8,), float("inf"), device=cuda)
    d, i, _, _ = ops.scan_verify(t["q"], t["q_paas"], codes, x, bound, cfg,
                                 k=10)
    # each winner is followed by its later twin, at the same distance
    assert (i[:, ::2] < 300).all()
    _same(i[:, 1::2], i[:, ::2] + 300)
    _same(d[:, 1::2], d[:, ::2])
    cpu = ops.scan_verify(t["q"].cpu(), t["q_paas"].cpu(), codes.cpu(),
                          x.cpu(), bound.cpu(), cfg, k=10)
    _same(i, cpu[1])
    _same(d, cpu[0])


def test_scan_verify_rejects_large_k(cuda):
    cfg = S.SummaryConfig(64, 8, 4)
    t = _inputs(1, 100, 2, cfg, cuda)
    with pytest.raises(ValueError):
        ops.scan_verify(t["q"], t["q_paas"], t["codes"], t["x"],
                        torch.ones(2, device=cuda), cfg, k=65)


def _scan_case(seed, n, nq, L, dev, w=16):
    cfg = S.SummaryConfig(L, w, 8)
    t = _inputs(seed, n, nq, cfg, dev)
    ed = ops.batch_euclid_multi(t["q"], t["x"])
    return cfg, t, ed


def _scan_same_as_twin(cfg, t, bound, k, dead=None):
    """scan_verify on the card == its twin on the card and on the CPU, bit
    for bit (dists, rows, counts, union); returns the card's outputs."""
    got = ops.scan_verify(t["q"], t["q_paas"], t["codes"], t["x"], bound,
                          cfg, k=k, dead=dead)
    torch.cuda.synchronize()
    lower, upper = S.region_bounds(cfg.bits, device=bound.device)
    n = t["x"].shape[0]
    want = ref.scan_verify_ref(
        t["q"], t["q_paas"], t["codes"], t["x"], lower, upper, bound,
        torch.zeros(n, dtype=torch.int32, device=bound.device)
        if dead is None else dead.to(torch.int32),
        scale=cfg.series_len / cfg.segments, k=k)
    cpu = ops.scan_verify(t["q"].cpu(), t["q_paas"].cpu(), t["codes"].cpu(),
                          t["x"].cpu(), bound.cpu(), cfg, k=k,
                          dead=None if dead is None else dead.cpu())
    for a, b_, c in zip(got, want, cpu):
        _same(a, b_)
        _same(a, c)
    return got


@pytest.mark.parametrize("k", (1, 10, 64))
@pytest.mark.parametrize("L", (64, 256, 1024))
@pytest.mark.parametrize("nq", (1, 8, 64, 100))
@pytest.mark.parametrize("n", NS)
def test_scan_verify_launch_shapes(cuda, n, nq, L, k):
    """Every launch plan the wrapper makes: one tile (n=1) to a full grid,
    one to four query mask words (Q=100 crosses 64), query chunks looped in
    the block (L=1024 at Q >= 64 does not fit shared memory at once)."""
    cfg, t, ed = _scan_case(n * 7 + nq + L + k, n, nq, L, cuda)
    if L == 1024 and nq >= 64:
        assert launch_plan(nq, n, L, 16, min(k, n), 256).chunks > 1
    dead = torch.from_numpy(
        np.random.default_rng(n + k).random(n) < 0.2).to(cuda)
    bound = ed.median(dim=1).values
    for dd in (None, dead):
        _scan_same_as_twin(cfg, t, bound, min(k, n), dd)


@pytest.mark.parametrize("n", NS)
def test_scan_verify_every_row_or_none_live(cuda, n):
    cfg, t, ed = _scan_case(n + 11, n, 64, 256, cuda)
    k = min(10, n)
    d, i, c, u = _scan_same_as_twin(
        cfg, t, torch.full((64,), float("inf"), device=cuda), k)
    assert int(u) == n and (c == n).all()
    _same(d, torch.sort(ed, dim=1, stable=True).values[:, :k])
    d, i, c, u = _scan_same_as_twin(cfg, t, torch.zeros(64, device=cuda), k)
    assert torch.isinf(d).all() and (i == -1).all()
    assert int(u) == 0 and (c == 0).all()
    # every row dead under an infinite bound: nothing is live either
    d, i, c, u = _scan_same_as_twin(
        cfg, t, torch.full((64,), float("inf"), device=cuda), k,
        dead=torch.ones(n, dtype=torch.bool, device=cuda))
    assert int(u) == 0 and (i == -1).all()


def test_scan_verify_workspace_across_shapes(cuda):
    """Calls in a row at shapes with other grids, chunks and k reuse (and
    grow) the workspace; a stale list, count or ticket would show."""
    cases = [(2037, 64, 256, 10), (257, 100, 1024, 64), (1, 8, 64, 1),
             (2037, 64, 256, 10), (2000, 1, 256, 64), (257, 100, 1024, 64)]
    for j, (n, nq, L, k) in enumerate(cases):
        cfg, t, ed = _scan_case(j % 3, n, nq, L, cuda)
        _scan_same_as_twin(cfg, t, ed.median(dim=1).values, min(k, n))


def test_scan_verify_repeatable(cuda):
    """The blocks finish in no fixed order; the answer must not care."""
    cfg, t, ed = _scan_case(5, 2037, 64, 256, cuda)
    bound = ed.quantile(0.7, dim=1)
    first = _scan_same_as_twin(cfg, t, bound, 10)
    for _ in range(20):
        again = ops.scan_verify(t["q"], t["q_paas"], t["codes"], t["x"],
                                bound, cfg, k=10)
        for a, b_ in zip(again, first):
            _same(a, b_)


@pytest.mark.parametrize("L", (64, 256, 100))
def test_scan_verify_dists_are_batch_euclid_bits(cuda, L):
    """A live pair's distance has the bits of batch_euclid on that pair
    (the eager chain), so fused and eager answers agree bitwise."""
    cfg, t, ed = _scan_case(L, 2037, 64, L, cuda, w=4)
    for bound in (torch.full((64,), float("inf"), device=cuda),
                  ed.median(dim=1).values):
        d, i, _, _ = _scan_same_as_twin(cfg, t, bound, 64)
        fin = i >= 0
        _same(d[fin], ops.batch_euclid_multi(t["q"], t["x"],
                                             idx=i.clamp(min=0))[fin])


@pytest.mark.parametrize("b", BITS)
@pytest.mark.parametrize("n", NS)
def test_fused_build_kernel(cuda, n, b):
    for cfg in CFGS[b]:
        t = _inputs(n + b, n, 1, cfg, cuda)
        paa, codes, keys = ops.summarize_and_key(t["x"], cfg)
        torch.cuda.synchronize()
        bps = S.breakpoints(b, device=cuda)
        r_paa, r_codes, r_keys = ref.fused_build_ref(
            t["x"], bps, segments=cfg.segments, bits=b)
        _same(paa, r_paa)
        _same(codes, r_codes)
        _same(keys, r_keys)
        c_paa, c_codes, c_keys = ops.summarize_and_key(t["x"].cpu(), cfg)
        _same(paa, c_paa)
        _same(codes, c_codes)
        _same(keys, c_keys)


PACK_BITS = (1, 3, 4, 5, 8)


@pytest.mark.parametrize("b", PACK_BITS)
@pytest.mark.parametrize("n", NS)
def test_sax_summarize_and_zorder_kernels(cuda, n, b):
    for cfg in (S.SummaryConfig(64, 8, b), S.SummaryConfig(256, 16, b)):
        t = _inputs(n + 5 * b, n, 1, cfg, cuda)
        paa, codes = ops.sax_summarize(t["x"], cfg)
        keys = ops.zorder(codes, cfg)
        torch.cuda.synchronize()
        bps = S.breakpoints(b, device=cuda)
        r_paa, r_codes = ref.sax_summarize_ref(t["x"], bps,
                                               segments=cfg.segments)
        _same(paa, r_paa)
        _same(codes, r_codes)
        _same(keys, ref.zorder_ref(codes, w=cfg.segments, b=b))
        c_paa, c_codes = ops.sax_summarize(t["x"].cpu(), cfg)
        _same(paa, c_paa)
        _same(codes, c_codes)
        _same(keys, ops.zorder(codes.cpu(), cfg))
        # the two construction stages equal the fused kernel bit for bit
        f_paa, f_codes, f_keys = ops.summarize_and_key(t["x"], cfg)
        _same(paa, f_paa)
        _same(codes, f_codes)
        _same(keys, f_keys)


@pytest.mark.parametrize("b", PACK_BITS)
@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("n", NS)
def test_unpack_mindist_kernel(cuda, n, nq, b):
    for cfg in (S.SummaryConfig(64, 8, b), S.SummaryConfig(256, 16, b)):
        t = _inputs(n + 7 * nq + b, n, nq, cfg, cuda)
        packed = torch.from_numpy(pack_codes(t["codes"].cpu().numpy(),
                                             b)).to(cuda)
        got = ops.mindist_batch_packed(t["q_paas"], packed, cfg)
        torch.cuda.synchronize()
        lower, upper = S.region_bounds(b, device=cuda)
        scale = cfg.series_len / cfg.segments
        _same(got, ref.mindist_batch_packed_ref(
            t["q_paas"], packed, lower, upper, scale, w=cfg.segments, b=b))
        _same(got, ops.mindist_batch_packed(t["q_paas"].cpu(), packed.cpu(),
                                            cfg))
        # packed == unpacked: the same bits as mindist_batch on the codes
        _same(got, ops.mindist_batch(t["q_paas"], t["codes"], cfg))
        # a view into the middle of a packed column (no row of padding)
        if n > 2:
            _same(ops.mindist_batch_packed(t["q_paas"], packed[1:-1], cfg),
                  got[:, 1:-1])


# the bound tile's launch plan (mindist_batch and unpack_mindist): N at
# every edge of one and two row tiles, Q across every query tile (1, 2 or 4
# per thread) and the grid's second axis, w through the 16-byte (w = 16,
# 64, a row read in chunks) and byte-wise (w = 8) code reads
MD_NS = (1, MD_ROWS - 1, MD_ROWS, MD_ROWS + 1, 2 * MD_ROWS - 1, 2 * MD_ROWS,
         2 * MD_ROWS + 1, 2037)
MD_QS = (1, 2, 3, 4, 5, 8, 9, 16, 17, 64, 65)
MD_WS = (8, 16, 64)


def _bound_inputs(seed, nq, n, w, b, dev):
    """Random codes (reaching the -inf / +inf table ends) and query PAAs,
    a quarter of them exactly on a breakpoint."""
    rng = np.random.default_rng(seed)
    lower, upper = S.region_bounds(b)
    codes = rng.integers(0, 1 << b, (n, w), dtype=np.uint8)
    q = rng.standard_normal((nq, w)).astype(np.float32)
    on = rng.random((nq, w)) < 0.25
    q[on] = upper.numpy()[rng.integers(0, (1 << b) - 1, on.sum())]
    return (torch.from_numpy(q).to(dev), torch.from_numpy(codes).to(dev),
            lower.to(dev), upper.to(dev))


def _bounds_same_as_twins(q, codes, lower, upper, cfg):
    """mindist_batch on the codes and unpack_mindist on their packed rows,
    each == its twin on the card and on the CPU, and == each other, bit
    for bit; returns the card's bound."""
    b, w = cfg.bits, cfg.segments
    scale = cfg.series_len / w
    got = ops.mindist_batch(q, codes, cfg)
    torch.cuda.synchronize()
    _same(got, ref.mindist_batch_ref(q, codes, lower, upper, scale))
    _same(got, ops.mindist_batch(q.cpu(), codes.cpu(), cfg))
    packed = torch.from_numpy(pack_codes(codes.cpu().numpy(), b)).to(q.device)
    pk = ops.mindist_batch_packed(q, packed, cfg)
    torch.cuda.synchronize()
    _same(pk, ref.mindist_batch_packed_ref(q, packed, lower, upper, scale,
                                           w=w, b=b))
    _same(pk, got)          # packed == unpacked
    return got


@pytest.mark.parametrize("w", MD_WS)
@pytest.mark.parametrize("nq", MD_QS)
def test_bound_tile_edges(cuda, nq, w):
    for b in range(1, 9):
        cfg = S.SummaryConfig(4 * w, w, b)
        q, codes, lower, upper = _bound_inputs(nq * w + b, nq, MD_NS[-1], w,
                                               b, cuda)
        for n in MD_NS:
            got = _bounds_same_as_twins(q, codes[:n].contiguous(), lower,
                                        upper, cfg)
            if nq > 1:      # Q=1 is row 0 of the batch
                _same(ops.mindist(q[0], codes[:n], cfg), got[0])


@pytest.mark.parametrize("w", MD_WS)
def test_bound_tile_unaligned_and_offset_views(cuda, w):
    """Codes and packed rows at every byte offset of a 16-byte word (the
    in-place reads fall back from 16-byte loads to bytes; the staged copy
    funnel-shifts two words), and views into the middle of a column."""
    for b in (1, 3, 5, 7, 8):
        cfg = S.SummaryConfig(4 * w, w, b)
        q, codes, lower, upper = _bound_inputs(w + b, 17, 300, w, b, cuda)
        want = _bounds_same_as_twins(q, codes, lower, upper, cfg)
        packed = torch.from_numpy(pack_codes(codes.cpu().numpy(), b)).to(cuda)
        for off in range(16):
            buf = torch.zeros(codes.numel() + 16, dtype=torch.uint8,
                              device=cuda)
            view = buf[off:off + codes.numel()].view(codes.shape)
            view.copy_(codes)
            _same(ops.mindist_batch(q, view, cfg), want)
            pbuf = torch.zeros(packed.numel() + 16, dtype=torch.uint8,
                               device=cuda)
            pview = pbuf[off:off + packed.numel()].view(packed.shape)
            pview.copy_(packed)
            _same(ops.mindist_batch_packed(q, pview, cfg), want)
        _same(ops.mindist_batch(q, codes[1:], cfg), want[:, 1:])
        _same(ops.mindist_batch_packed(q, packed[1:-1], cfg), want[:, 1:-1])


def test_bound_tile_repeatable(cuda):
    """20 launches at the main path's shape give the same bits."""
    cfg = S.SummaryConfig(256, 16, 8)
    q, codes, lower, upper = _bound_inputs(3, 64, 2000, 16, 8, cuda)
    packed = torch.from_numpy(pack_codes(codes.cpu().numpy(), 8)).to(cuda)
    first = ops.mindist_batch(q, codes, cfg)
    for _ in range(20):
        _same(ops.mindist_batch(q, codes, cfg), first)
        _same(ops.mindist_batch_packed(q, packed, cfg), first)


@pytest.mark.parametrize("b", BITS)
def test_scan_verify_counts_are_bound_tile_live_pairs(cuda, b):
    """scan_verify's per-query live counts at a bound equal the pairs the
    bound tile puts under it: the two kernels' bounds share their terms."""
    cfg = S.SummaryConfig(256, 16, b)
    t = _inputs(b, 2037, 64, cfg, cuda)
    md = ops.mindist_batch(t["q_paas"], t["codes"], cfg)
    for bound in (md.median(dim=1).values, md.min(dim=1).values,
                  torch.full((64,), float("inf"), device=cuda)):
        counts = ops.scan_verify(t["q"], t["q_paas"], t["codes"], t["x"],
                                 bound, cfg, k=10)[2]
        _same(counts, (md < bound[:, None]).sum(1).to(counts.dtype))


def test_wrappers_count_launches(cuda):
    cfg = S.SummaryConfig(64, 8, 4)
    t = _inputs(5, 100, 4, cfg, cuda)
    before = dict(loader.LAUNCHES)
    ops.mindist_batch(t["q_paas"], t["codes"], cfg)
    ops.batch_euclid_multi(t["q"], t["x"])
    ops.summarize_and_key(t["x"], cfg)
    ops.scan_verify(t["q"], t["q_paas"], t["codes"], t["x"],
                    torch.ones(4, device=cuda), cfg, k=1)
    _, codes = ops.sax_summarize(t["x"], cfg)
    ops.zorder(codes, cfg)
    packed = torch.from_numpy(pack_codes(codes.cpu().numpy(), 4)).to(cuda)
    ops.mindist_batch_packed(t["q_paas"], packed, cfg)
    for name in ("mindist_batch", "batch_euclid", "fused_build",
                 "scan_verify", "sax_summarize", "zorder",
                 "unpack_mindist"):
        assert loader.LAUNCHES[name] == before.get(name, 0) + 1


# the summarize tile: the shipped shapes (a compile-time tile), and generic
# ones (w dividing 32, a multiple of 32, neither; L not a multiple of 4)
SUM_SHAPES = ((256, 16), (64, 8), (60, 12), (300, 12), (256, 64), (256, 32),
              (256, 4), (50, 5))
SUM_GRID = SUM_SMS * SUM_BLOCKS_PER_SM


def _sum_ns(w):
    """N at every edge of one and two tiles and of the persistent grid's
    first pass and wrap."""
    rows = sum_plan(1, w).rows
    g = rows * SUM_GRID
    return sorted({1, rows - 1, rows, rows + 1, 2 * rows + 1, g - 1, g,
                   g + 1, g + rows + 1, 2 * g + 3} - {0})


def _summaries_same_as_twins(x, cfg):
    """Both kernels equal their twins on the same CUDA tensors, and
    sax_summarize + zorder == fused_build, bit for bit."""
    b, w = cfg.bits, cfg.segments
    bps = S.breakpoints(b, device=x.device)
    paa, codes = ops.sax_summarize(x, cfg)
    f_paa, f_codes, f_keys = ops.summarize_and_key(x, cfg)
    torch.cuda.synchronize()
    r_paa, r_codes, r_keys = ref.fused_build_ref(x, bps, segments=w, bits=b)
    _same(paa.view(torch.int32), r_paa.view(torch.int32))
    _same(codes, r_codes)
    _same(f_paa.view(torch.int32), r_paa.view(torch.int32))
    _same(f_codes, r_codes)
    _same(f_keys, r_keys)
    if w <= 64:
        _same(ops.zorder(codes, cfg), f_keys)
    return f_paa, f_codes, f_keys


@pytest.mark.parametrize("L,w", SUM_SHAPES)
def test_summarize_tile_edges(cuda, L, w):
    ns = _sum_ns(w)
    for b in (1, 3, 8):
        cfg = S.SummaryConfig(L, w, b)
        x = torch.from_numpy(_walks(np.random.default_rng(L + w + b),
                                    ns[-1], L)).to(cuda)
        for n in ns:
            _summaries_same_as_twins(x[:n], cfg)
        # and against the twin on the CPU, at the widest edge
        got = ops.summarize_and_key(x, cfg)
        for g, c in zip(got, ops.summarize_and_key(x.cpu(), cfg)):
            _same(g, c)


@pytest.mark.parametrize("L,w", SUM_SHAPES)
def test_summarize_tile_unaligned_and_offset_views(cuda, L, w):
    """x at every 4-byte offset of a 16-byte word (the shipped shapes then
    take the generic tile), and row slices: the same bits as aligned."""
    cfg = S.SummaryConfig(L, w, 8)
    x = torch.from_numpy(_walks(np.random.default_rng(w), 301, L)).to(cuda)
    want = _summaries_same_as_twins(x, cfg)
    for off in range(4):
        buf = torch.zeros(x.numel() + 4, dtype=torch.float32, device=cuda)
        view = buf[off:off + x.numel()].view(x.shape)
        view.copy_(x)
        for g, w_ in zip(_summaries_same_as_twins(view, cfg), want):
            _same(g, w_)
    for g, w_ in zip(_summaries_same_as_twins(x[1:], cfg), want):
        _same(g, w_[1:])
    for g, w_ in zip(_summaries_same_as_twins(x[3:-2], cfg), want):
        _same(g, w_[3:-2])


def test_summarize_tile_repeatable(cuda):
    """20 launches at one external-sort chunk (and a ragged tail) give the
    same bits."""
    cfg = S.SummaryConfig(256, 16, 8)
    x = torch.from_numpy(_walks(np.random.default_rng(20), 65_536 + 17,
                                256)).to(cuda)
    first = _summaries_same_as_twins(x, cfg)
    for _ in range(20):
        for g, w_ in zip(ops.summarize_and_key(x, cfg), first):
            _same(g, w_)
        for g, w_ in zip(ops.sax_summarize(x, cfg), first):
            _same(g, w_)


@pytest.mark.parametrize("w", (16, 12))
def test_summarize_tile_long_rows(cuda, w):
    """L = 60,000 (once refused for its shared memory): the generic tile
    reads each segment from device memory, so any length runs."""
    cfg = S.SummaryConfig(60_000, w, 8)
    x = torch.from_numpy(_walks(np.random.default_rng(w), 3,
                                60_000)).to(cuda)
    _summaries_same_as_twins(x, cfg)


# zorder: every width (the ballot widths 8, 16, 64 at compile time, 1, 2,
# 4, 32 at run time; the rest through run_word), b where codes straddle
# nibbles, N at one row, a ragged 31, one past a tile and past a chunk
ZO_BITS = (1, 3, 5, 8)


def _zorder_same_as_twin(codes, w, b):
    cfg = S.SummaryConfig(w, w, b)
    keys = ops.zorder(codes, cfg)
    torch.cuda.synchronize()
    _same(keys, ref.zorder_ref(codes, w=w, b=b))
    return keys


@pytest.mark.parametrize("w", range(1, 65))
def test_zorder_kernel_sweep(cuda, w):
    rng = np.random.default_rng(w)
    ns = sorted({1, 31, zorder_plan(1, w).rows + 1, 65_537})
    for b in ZO_BITS:
        codes = torch.from_numpy(rng.integers(0, 1 << b, (ns[-1], w),
                                              dtype=np.uint8)).to(cuda)
        for n in ns:
            keys = _zorder_same_as_twin(codes[:n], w, b)
            _same(keys, ops.zorder(codes[:n].cpu(), S.SummaryConfig(w, w, b)))


@pytest.mark.parametrize("w", (1, 3, 8, 12, 16, 20, 63, 64))
def test_zorder_kernel_offset_views(cuda, w):
    """Row slices: codes[1:] (16-byte aligned only where 16 divides w) and
    a view at every byte offset of a 16-byte word, both load paths: the
    same keys as the aligned rows."""
    rng = np.random.default_rng(30 + w)
    n = 2 * zorder_plan(1, w).rows + 5
    codes = torch.from_numpy(rng.integers(0, 256, (n, w),
                                          dtype=np.uint8)).to(cuda)
    want = _zorder_same_as_twin(codes, w, 8)
    _same(_zorder_same_as_twin(codes[1:], w, 8), want[1:])
    _same(_zorder_same_as_twin(codes[3:-2], w, 8), want[3:-2])
    for off in range(16):
        buf = torch.zeros(codes.numel() + 16, dtype=torch.uint8, device=cuda)
        view = buf[off:off + codes.numel()].view(codes.shape)
        view.copy_(codes)
        _same(_zorder_same_as_twin(view, w, 8), want)


@pytest.mark.parametrize("w", (16, 12, 64, 8))
def test_zorder_kernel_top_bit_words(cuda, w):
    """Code 128 in segment 0 at b = 8 sets bit 31 of word 0: the int64
    word is 2^31 exactly (zero-extended, never negative)."""
    codes = torch.zeros((300, w), dtype=torch.uint8, device=cuda)
    codes[:, 0] = 128
    keys = _zorder_same_as_twin(codes, w, 8)
    assert (keys[:, 0] == 1 << 31).all() and (keys >= 0).all()
    full = _zorder_same_as_twin(torch.full_like(codes, 255), w, 8)
    assert (full == (1 << 32) - 1).sum() > 0 and (full >= 0).all()


@pytest.mark.parametrize("L,w", ((256, 16), (64, 8), (300, 12)))
def test_sax_summarize_and_zorder_equal_fused_build(cuda, L, w):
    """The two construction stages and the fused kernel, bit for bit, at
    one external-sort chunk and a ragged tail, every b."""
    x = torch.from_numpy(_walks(np.random.default_rng(L + w), 65_536 + 17,
                                L)).to(cuda)
    for b in range(1, 9):
        cfg = S.SummaryConfig(L, w, b)
        paa, codes = ops.sax_summarize(x, cfg)
        keys = _zorder_same_as_twin(codes, w, b)
        for g, want in zip((paa, codes, keys), ops.summarize_and_key(x, cfg)):
            _same(g, want)


# the exact scan's pool fold: kernel == twin, four groups folded in turn so
# the pools carry over, distances on a coarse grid (ties everywhere),
# duplicate rows, infinite and NaN-free candidates, a group folded again
# (every id already pooled), dead rows, k up to the kernel's 256, B past
# one and two tiles of 1024 rows, a short last leaf
POOL_SHAPES = ((1, 1, 2000), (8, 2, 2000), (64, 1, 2000), (64, 2, 1000),
               (3, 5, 257), (130, 1, 64))


def _pool_state(rng, nq, k, n, n_leaves, leaf, dev):
    ext = np.full(nq, np.inf, np.float32)
    ext[::4] = rng.uniform(2, 8, len(ext[::4]))
    st = dict(best_d=torch.full((nq, k), float("inf")),
              best_off=torch.full((nq, k), -1, dtype=torch.int64),
              ext=torch.from_numpy(ext),
              counts=torch.zeros(nq, dtype=torch.int64),
              row_mark=torch.zeros(n_leaves * leaf, dtype=torch.uint8),
              leaf_mark=torch.zeros((nq, n_leaves), dtype=torch.uint8))
    return {name: t.to(dev) for name, t in st.items()}


@pytest.mark.parametrize("k", (1, 10, 256))
@pytest.mark.parametrize("nq,b_leaves,leaf", POOL_SHAPES)
def test_pool_merge_kernel(cuda, nq, b_leaves, leaf, k):
    rng = np.random.default_rng(nq * 1000 + k + leaf)
    n_leaves = 7
    n = n_leaves * leaf - 5
    ids = torch.from_numpy(rng.permutation(4 * n)[:n].astype(np.int64))
    dead = torch.from_numpy(rng.random(n) < 0.1)
    cpu = _pool_state(rng, nq, k, n, n_leaves, leaf, "cpu")
    card = {name: t.to(cuda) for name, t in cpu.items()}
    groups = [np.sort(rng.choice(n_leaves, b_leaves, replace=False))
              for _ in range(3)]
    groups.insert(2, groups[0])                    # rows found again
    inputs = []
    for leaves in groups:
        b = (len(leaves) - 1) * leaf + min(leaf, n - int(leaves[-1]) * leaf)
        dd = rng.integers(0, 60, (nq, b)).astype(np.float32) / 4
        dd[:, ::5] = dd[:, :1]
        dd[rng.random((nq, b)) < 0.01] = np.inf
        md = np.minimum(dd, rng.uniform(0, 15, (nq, b)).astype(np.float32))
        inputs.append((torch.from_numpy(md), torch.from_numpy(dd),
                       torch.from_numpy(leaves.astype(np.int64))))
    inputs[2] = inputs[0]
    before = loader.LAUNCHES["pool_merge"]
    for gi, (md, dd, leaves) in enumerate(inputs):
        use_dead = dead if gi % 2 else None
        ref.pool_merge_ref(md, dd, leaves, leaf, use_dead, ids, **cpu)
        ops.pool_merge(md.to(cuda), dd.to(cuda), leaves.to(cuda), leaf,
                       None if use_dead is None else use_dead.to(cuda),
                       ids.to(cuda), **card)
        torch.cuda.synchronize()
        for name, t in cpu.items():
            got = card[name]
            if t.dtype == torch.float32:
                t, got = t.view(torch.int32), got.view(torch.int32)
            _same(got, t)
    assert loader.LAUNCHES["pool_merge"] == before + len(inputs)
    assert int(cpu["counts"].sum()) > 0 and cpu["best_off"].max() >= 0


def test_pool_merge_rejects_large_k(cuda):
    z = torch.zeros((2, 10), device=cuda)
    st = _pool_state(np.random.default_rng(0), 2, 257, 10, 1, 10, cuda)
    with pytest.raises(ValueError):
        ops.pool_merge(z, z, torch.zeros(1, dtype=torch.int64, device=cuda),
                       10, None, torch.arange(10, device=cuda), **st)


def test_card_loop_never_waits(cuda, monkeypatch):
    """One exact batch of 64 queries over 2^23 walks of the paper's shape
    (half of them dataset rows): every synchronizing call is an error from
    the loop's first launch to its ``sync`` stage, the merge kernel runs
    once a group, and the batch's round trips are the seed's two and the
    partition's one."""
    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.core import tree as T
    from repro_torch.query import executor as X
    g = torch.Generator(device=cuda).manual_seed(7)
    raw = torch.randn((1 << 23, INDEX.series_len), generator=g,
                      device=cuda).cumsum_(1)
    tree = T.build(raw, INDEX, leaf_size=LEAF_SIZE, znorm=True, device=cuda)
    del raw
    q = tree.raw[torch.randint(0, tree.n, (64,), generator=g,
                               device=cuda)].cpu().numpy()
    walks = np.cumsum(np.random.default_rng(7).standard_normal(
        (32, INDEX.series_len)), 1)
    q[1::2] = (walks - walks.mean(1, keepdims=True)) / walks.std(
        1, keepdims=True)
    T.exact_search_batch(tree, q, k=10)            # warm: tables, plans
    issue = X._issue_groups
    groups = []

    def strict(*a, **kw):
        groups.append(len(a[3]))           # _issue_groups(.., groups, ..)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return issue(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setattr(X, "_issue_groups", strict)
    before = loader.LAUNCHES["pool_merge"]
    _, o, st = T.exact_search_batch(tree, q, k=10)
    merges = loader.LAUNCHES["pool_merge"] - before
    print(f"\npool_merge launches {merges} over {sum(groups)} groups; "
          f"host_syncs {st.host_syncs}; leaves_scanned "
          f"{st.leaves_scanned}; LAUNCHES {dict(loader.LAUNCHES)}")
    assert merges == sum(groups) > 0 and st.leaves_scanned > 0
    assert st.host_syncs == 3
    assert (o[::2] >= 0).all()
    del tree
    torch.cuda.empty_cache()
