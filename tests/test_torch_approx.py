"""Port parity: budgeted approximate search (``query/approx.py``) and
``exact_search_budgeted``, PyTorch (CPU twins) vs the JAX reference, plus
the budget battery of the reference's own approx tests run on the port.

Both packages get the same numpy inputs (the smoke config: L=64, w=8,
b=4, leaf 64; 4000 random walks).  Tolerances: answer ids, leaf counts,
``scan_bytes``, ``budget_exhausted`` and ``certified`` exact; answer
distances and gaps at rtol 1e-6 with atol 1e-6 (float32 sums ordered
differently by XLA and torch); within the port, unlimited budget ==
exact bit for bit and ``gap == 0``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import summarization as RS
from repro.core import tree as RT
from repro.query import Partition as RPartition
from repro.query import approx_knn as r_approx_knn
from repro.query import certified_gap as r_certified_gap
from repro_torch.configs import SMOKE_INDEX as CFG
from repro_torch.configs import SMOKE_LEAF as LEAF
from repro_torch.core import tree as T
from repro_torch.core.lsm import CoconutLSM
from repro_torch.core.metrics import IOStats
from repro_torch.query import (Budget, Partition, approx_knn, as_budget,
                               certified_gap, progressive_knn)
from repro_torch.storage import Segment, exact_search_mmap

N = 4000
NQ = 6
L = CFG.series_len
RCFG = RS.SummaryConfig(CFG.series_len, CFG.segments, CFG.bits)
TOL = dict(rtol=1e-6, atol=1e-6)


def _walks(rng, n, length):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    raw = _walks(rng, N, L)
    q = _walks(rng, NQ, L)
    q[::2] = raw[rng.integers(0, N, (NQ + 1) // 2)] + 0.1 * \
        rng.standard_normal(((NQ + 1) // 2, L)).astype(np.float32)
    return raw, q


@pytest.fixture(scope="module")
def trees(data):
    raw, _ = data
    return (RT.build(jnp.asarray(raw), RCFG, leaf_size=LEAF),
            T.build(raw, CFG, leaf_size=LEAF, device="cpu"))


@pytest.fixture(scope="module")
def tree(trees):
    return trees[1]


@pytest.fixture(scope="module")
def segment(tree, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("seg") / "t.coco")
    T.save(tree, path)
    seg = Segment.open(path)
    yield seg
    seg.close()


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------- parity vs reference

@pytest.mark.parametrize("budget", [
    {"max_leaves": 0}, {"max_leaves": 1}, {"max_leaves": 3},
    {"max_leaves": 8}, {"max_leaves": 20}, {"max_bytes": 0},
    {"max_bytes": 30_000}, {"max_bytes": 100_000},
    {"max_leaves": 10, "max_bytes": 60_000}, {}],
    ids=lambda b: "-".join(f"{k}{v}" for k, v in b.items()) or "unlimited")
@pytest.mark.parametrize("k", [1, 5])
def test_approx_knn_matches_reference(data, trees, budget, k):
    """The same leaves scanned, bytes charged, answer ids and exhaustion
    flag as the reference's drain at every leaf and byte budget; the
    distances and the gap to float tolerance."""
    raw, q = data
    rt, pt = trees
    rd, ro, rs = r_approx_knn([RPartition.from_tree(rt)], q, RCFG, k=k,
                              budget=budget)
    pd, po, ps = approx_knn([Partition.from_tree(pt)], q, CFG, k=k,
                            budget=budget)
    np.testing.assert_array_equal(po, ro)
    np.testing.assert_allclose(pd, rd, **TOL)
    assert ps.leaves_scanned == rs.leaves_scanned
    assert ps.leaves_pruned == rs.leaves_pruned
    assert ps.scan_bytes == rs.scan_bytes
    assert ps.candidates == rs.candidates
    assert ps.budget_exhausted == rs.budget_exhausted
    assert ps.exact == rs.exact
    np.testing.assert_array_equal(ps.leaves_per_query, rs.leaves_per_query)
    np.testing.assert_allclose(ps.gap, rs.gap, **TOL)
    np.testing.assert_allclose(ps.lb_unvisited, rs.lb_unvisited, **TOL)


@pytest.mark.parametrize("budget", [None, 0, 5, {"max_bytes": 50_000}])
def test_tree_budget_routes_match_reference(data, trees, budget):
    """``exact_search_batch(budget=)`` and ``mode="approx"`` route to the
    drain in both packages; ``exact_search`` is its Q = 1 row."""
    raw, q = data
    rt, pt = trees
    rd, ro, rs = RT.exact_search_batch(rt, q, k=3, budget=budget,
                                       mode="approx")
    pd, po, ps = T.exact_search_batch(pt, q, k=3, budget=budget,
                                      mode="approx")
    np.testing.assert_array_equal(po, ro)
    np.testing.assert_allclose(pd, rd, **TOL)
    assert ps.leaves_scanned == rs.leaves_scanned
    np.testing.assert_allclose(ps.gap, rs.gap, **TOL)
    sd, so, ss = T.exact_search(pt, q[2], k=3, budget=budget,
                                mode="approx")
    d1, o1, _ = T.exact_search_batch(pt, q[2:3], k=3, budget=budget,
                                     mode="approx")
    np.testing.assert_array_equal(_bits(sd), _bits(d1[0]))
    np.testing.assert_array_equal(so, o1[0])


def test_unlimited_budget_is_exact_bits(data, trees):
    """An unlimited budget gives the exact path's bits with ``gap == 0``,
    and the reference's answers."""
    raw, q = data
    rt, pt = trees
    d_ex, o_ex, _ = T.exact_search_batch(pt, q, k=5)
    for budget in (None, Budget(), {}):
        d, o, st = T.exact_search_batch(pt, q, k=5, budget=budget,
                                        mode="approx")
        np.testing.assert_array_equal(_bits(d), _bits(d_ex))
        np.testing.assert_array_equal(o, o_ex)
        assert np.all(st.gap == 0) and st.exact
    rd, ro, _ = RT.exact_search_batch(rt, q, k=5, mode="approx")
    np.testing.assert_array_equal(o_ex, ro)
    np.testing.assert_allclose(d_ex, rd, **TOL)


@pytest.mark.parametrize("kth, lb", [
    ([1.0, 2.0, 3.0, np.inf], [0.5, 2.5, np.inf, 1.0]),
    ([np.inf, np.inf], [np.inf, 0.0]),
    ([0.0, 5.5, 7.25], [0.0, 5.5, 8.0]),
])
def test_certified_gap_matches_reference(kth, lb):
    kth = np.asarray(kth, np.float32)
    lb = np.asarray(lb, np.float32)
    got = certified_gap(kth, lb)
    want = np.asarray(r_certified_gap(kth, lb))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tied_trees():
    """1000 walks, each four times over: every bound and distance ties in
    groups, so a budget cuts through tie groups."""
    rng = np.random.default_rng(3)
    raw = np.repeat(_walks(rng, 1000, L), 4, axis=0)
    q = _walks(rng, 6, L)
    q[:3] = raw[[5, 1234, 3999]] + 0.05 * rng.standard_normal(
        (3, L)).astype(np.float32)
    return (RT.build(jnp.asarray(raw), RCFG, leaf_size=LEAF),
            T.build(raw, CFG, leaf_size=LEAF, device="cpu"), q)


@pytest.mark.parametrize("budget", [1, 3, 7, 64, 333, 1024])
def test_exact_search_budgeted_matches_reference(data, trees, tied_trees,
                                                 budget):
    """The same best distance, offset and certificate as the reference's
    ``exact_search_budgeted`` (``jax.lax.top_k``, lowest index on ties),
    on random walks and on a tree whose bounds tie in groups of four."""
    raw, q = data
    for rt, pt, qs in ((*trees, q), tied_trees):
        for qi in range(len(qs)):
            rd, ro, rc = RT.exact_search_budgeted(rt, jnp.asarray(qs[qi]),
                                                  budget=budget)
            pd, po, pc = T.exact_search_budgeted(pt, qs[qi], budget=budget)
            assert po == int(ro) and pc == bool(rc), (qi, budget)
            np.testing.assert_allclose(pd, float(rd), **TOL)


@pytest.mark.parametrize("budget", [1, 2, 3, 5, 9])
def test_exact_search_budgeted_takes_lowest_rows_on_ties(budget):
    """Equal bounds at the budget's edge go to the lowest rows (the
    reference's ``jax.lax.top_k`` order), on the CPU twin's bounds: a
    stable sort keyed on the bound, never ``torch.topk``'s unordered ties.
    And a tree of six rows with one SAX word next to far rows answers as
    the reference does at every budget that cuts the tie group."""
    md = torch.tensor([3.0, 1.0, 2.0, 1.0, 1.0, 0.5, 1.0, 2.0, 1.0, 4.0])
    vals, rows = T._smallest_stable(md, budget)
    want = np.argsort(md.numpy(), kind="stable")[:budget]
    np.testing.assert_array_equal(rows.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(), md.numpy()[want])
    rng = np.random.default_rng(8)
    base = _walks(rng, 1, L)[0]
    rows = np.concatenate([
        np.stack([base + 1e-4 * i for i in range(6)]),
        -_walks(rng, 10, L)]).astype(np.float32)
    query = rows[5] + 1e-5
    pt = T.build(rows, CFG, leaf_size=1, device="cpu")
    rt = RT.build(jnp.asarray(rows), RCFG, leaf_size=1)
    codes = pt.codes.numpy()[np.argsort(pt.offsets.numpy())]  # row order
    assert (codes[:6] == codes[0]).all()
    pd, po, pc = T.exact_search_budgeted(pt, query, budget=budget)
    rd, ro, rc = RT.exact_search_budgeted(rt, jnp.asarray(query),
                                          budget=budget)
    assert po == int(ro) and pc == bool(rc)
    np.testing.assert_allclose(pd, float(rd), **TOL)


def test_exact_search_budgeted_certified_equals_exact(data, tree):
    raw, q = data
    d_ex, o_ex, _ = T.exact_search_batch(tree, q, k=1)
    for qi in range(NQ):
        d, o, cert = T.exact_search_budgeted(tree, q[qi], budget=N)
        assert cert
        assert o == o_ex[qi, 0]
        np.testing.assert_array_equal(_bits(d), _bits(d_ex[qi, 0]))
        d, o, cert = T.exact_search_budgeted(tree, q[qi], budget=200)
        if cert:
            assert o == o_ex[qi, 0]
    with pytest.raises(ValueError):
        T.exact_search_budgeted(tree, q[0], budget=0)


# ------------------------------------------------------------- budget kinds

def test_max_leaves_is_enforced_exactly(data, tree):
    """Leaf admission is checked leaf by leaf: the drain never streams
    more than ``max_leaves`` blocks, and when it stops early it says so
    (otherwise the answer is certified exact)."""
    raw, q = data
    for b in (0, 1, 3, 8, 20):
        d, off, st = T.exact_search_batch(tree, q, k=5, budget=b)
        assert st.leaves_scanned <= b
        assert st.budget_exhausted or st.exact
        assert np.all(np.isfinite(d))          # seeds always answer


def test_max_bytes_bounds_real_io_on_mmap(data, segment):
    """The byte budget caps the backend-independent ``scan_bytes`` charge
    AND the mmap backend's real ``bytes_read`` shrinks with it — pruned
    pages are never touched; the leaf scan's reads stay within it."""
    raw, q = data
    io_full = IOStats(64)
    _, _, st_full = exact_search_mmap(segment, q, k=5, io=io_full,
                                      device="cpu")
    io_seed = IOStats(64)
    exact_search_mmap(segment, q, k=5, io=io_seed,
                      budget=Budget(max_bytes=0), device="cpu")
    caps = [0, 30_000, None]
    reads, scans = [], []
    for cap in caps:
        io = IOStats(64)
        d, off, st = exact_search_mmap(
            segment, q, k=5, io=io, budget=Budget(max_bytes=cap),
            device="cpu")
        if cap is not None:
            assert st.scan_bytes <= cap
            assert io.bytes_read - io_seed.bytes_read <= cap
            assert st.budget_exhausted or st.exact
        assert np.all(np.isfinite(d))
        reads.append(io.bytes_read)
        scans.append(st.scan_bytes)
    assert scans[0] == 0                       # zero budget: seeds only
    assert scans[0] < scans[1] < scans[2]
    assert reads[0] < reads[1] < reads[2]      # fewer real pages touched
    assert scans[2] == st_full.scan_bytes      # unlimited == exact spend
    # the fence column is read once per segment (the envelopes are
    # cached), so a second exact search reads what the unlimited drain did
    io_again = IOStats(64)
    exact_search_mmap(segment, q, k=5, io=io_again, device="cpu")
    assert reads[2] == io_again.bytes_read < io_full.bytes_read


def test_mmap_budget_matches_tree_budget(data, tree, segment):
    """The segment and the tree hold the same rows in the same order, so
    a budgeted drain returns the same bits off either."""
    raw, q = data
    for budget in (0, 4, Budget(max_bytes=40_000)):
        d_t, o_t, s_t = T.exact_search_batch(tree, q, k=4, budget=budget)
        d_s, o_s, s_s = exact_search_mmap(segment, q, k=4, budget=budget,
                                          device="cpu")
        np.testing.assert_array_equal(_bits(d_s), _bits(d_t))
        np.testing.assert_array_equal(o_s, o_t)
        assert s_s.leaves_scanned == s_t.leaves_scanned
        np.testing.assert_array_equal(s_s.gap, s_t.gap)


def test_zero_budget_returns_seed_answers_with_finite_gap(data, tree):
    """A zero budget degrades to the Algorithm-4 probe: the same answers
    as ``approx_search_batch``, finite k-th distance, finite sound gap,
    and zero leaves charged."""
    raw, q = data
    d0, off0, st0 = T.exact_search_batch(tree, q, k=3, budget=0)
    assert st0.leaves_scanned == 0 and st0.scan_bytes == 0
    assert np.all(np.isfinite(d0))
    assert np.all(np.isfinite(st0.gap)) and np.all(st0.gap >= 0)
    da, offa, _ = T.approx_search_batch(tree, q, k=3)
    np.testing.assert_array_equal(_bits(d0), _bits(da))
    np.testing.assert_array_equal(off0, offa)
    d_ex, _, _ = T.exact_search_batch(tree, q, k=3)
    assert np.all(d_ex[:, -1] >= d0[:, -1] - st0.gap - 1e-3)


def test_deadline_terminates_and_reports_exhaustion(data, tree):
    """An already-expired deadline stops the drain before any leaf is
    charged; the seeds still answer.  A generous one completes exactly."""
    raw, q = data
    d, off, st = T.exact_search_batch(tree, q, k=3,
                                      budget=Budget(deadline_ms=0.0))
    assert st.budget_exhausted
    assert st.leaves_scanned == 0
    assert np.all(np.isfinite(d))
    d2, off2, st2 = T.exact_search_batch(
        tree, q, k=3, budget=Budget(deadline_ms=60_000.0))
    d_ex, off_ex, _ = T.exact_search_batch(tree, q, k=3)
    np.testing.assert_array_equal(_bits(d2), _bits(d_ex))
    np.testing.assert_array_equal(off2, off_ex)


# ------------------------------------------------------------ monotonicity

def test_answers_never_get_worse_as_budget_grows(data, tree):
    """The leaves scanned under budget b are a prefix of those under
    b' > b, so every k-th distance is non-increasing in the budget, the
    gap is sound at every rung, and the unlimited end is exact."""
    raw, q = data
    d_ex, off_ex, _ = T.exact_search_batch(tree, q, k=5)
    prev_kth = None
    for b in (0, 1, 2, 4, 8, 16, 32, None):
        d, off, st = T.exact_search_batch(tree, q, k=5, budget=b,
                                          mode="approx")
        kth = d[:, -1]
        if prev_kth is not None:
            assert np.all(kth <= prev_kth)
        assert np.all(d_ex[:, -1] >= kth - st.gap)
        prev_kth = kth
    np.testing.assert_array_equal(_bits(d), _bits(d_ex))
    np.testing.assert_array_equal(off, off_ex)
    assert np.all(st.gap == 0) and st.exact


@pytest.mark.parametrize("budget", [Budget(max_leaves=7),
                                    Budget(max_bytes=45_000)])
def test_same_budget_is_deterministic(data, tree, budget):
    raw, q = data
    d1, off1, st1 = T.exact_search_batch(tree, q, k=5, budget=budget)
    d2, off2, st2 = T.exact_search_batch(tree, q, k=5, budget=budget)
    np.testing.assert_array_equal(_bits(d1), _bits(d2))
    np.testing.assert_array_equal(off1, off2)
    assert st1.leaves_scanned == st2.leaves_scanned
    assert st1.scan_bytes == st2.scan_bytes


# ------------------------------------------------------------- progressive

def test_progressive_refinement_streams_improving_answers(data, tree):
    """The generator yields improving snapshots (k-th distance and gap
    non-increasing) and its final snapshot equals the one-shot
    ``approx_knn`` bit for bit."""
    raw, q = data
    part = [Partition.from_tree(tree)]
    b = Budget(max_leaves=16)
    snaps = list(progressive_knn(part, q, CFG, k=5, budget=b))
    assert len(snaps) >= 2                     # seeds + at least one group
    for (d0, _, s0), (d1, _, s1) in zip(snaps, snaps[1:]):
        assert np.all(d1[:, -1] <= d0[:, -1])
        assert np.all(s1.gap <= s0.gap)
    d_one, off_one, st_one = approx_knn(part, q, CFG, k=5, budget=b)
    d_f, off_f, st_f = snaps[-1]
    np.testing.assert_array_equal(_bits(d_f), _bits(d_one))
    np.testing.assert_array_equal(off_f, off_one)
    np.testing.assert_array_equal(st_f.gap, st_one.gap)


def test_progressive_close_abandons_the_scan(data, tree):
    raw, q = data
    gen = progressive_knn([Partition.from_tree(tree)], q, CFG, k=3)
    d0, _, s0 = next(gen)
    assert s0.leaves_scanned == 0 and np.all(np.isfinite(d0))
    next(gen)
    gen.close()


# --------------------------------------------------------- snapshot engine

def test_lsm_approx_default_is_seed_only_with_gap(data):
    """The streaming engine's approximate path runs the shared drain: the
    default budget scans zero leaves and the info dict certifies the
    answer; a budget buys leaves and tightens (or keeps) it."""
    raw, q = data
    with CoconutLSM(CFG, buffer_capacity=512, leaf_size=LEAF,
                    device="cpu") as lsm:
        lsm.insert(raw)
        lsm.flush()
        d, off, info = lsm.search_approx_batch(q, k=3)
        assert info["stats"].leaves_scanned == 0
        assert "gap" in info and np.all(info["gap"] >= 0)
        assert np.all(np.isfinite(d))
        d8, off8, info8 = lsm.search_approx_batch(q, k=3, budget=8)
        assert info8["stats"].leaves_scanned <= 8
        assert np.all(d8[:, -1] <= d[:, -1])
        d_ex, _, _ = lsm.search_exact_batch(q, k=3)
        assert np.all(d_ex[:, -1] >= d8[:, -1] - info8["gap"])
        # one query's frontier is its own: a budget buys it other leaves
        s_d, s_o, s_info = lsm.search_approx(q[1], k=3, budget=8)
        assert s_d.shape == (3,) and s_o.shape == (3,)
        assert d_ex[1, -1] >= s_d[-1] - s_info["gap"][0]


def test_budget_kwarg_normalization(data, tree):
    """Every entry point accepts None / int / dict / Budget, and an
    unknown mode is rejected."""
    raw, q = data
    assert as_budget(None) is None
    assert as_budget(5) == Budget(max_leaves=5)
    assert as_budget({"max_bytes": 100}) == Budget(max_bytes=100)
    b = Budget(deadline_ms=1.5)
    assert as_budget(b) is b
    assert Budget().unlimited and not Budget(max_leaves=0).unlimited
    d_i, off_i, _ = T.exact_search_batch(tree, q, k=2, budget=3)
    d_d, off_d, _ = T.exact_search_batch(tree, q, k=2,
                                         budget={"max_leaves": 3})
    np.testing.assert_array_equal(_bits(d_i), _bits(d_d))
    np.testing.assert_array_equal(off_i, off_d)
    with pytest.raises(ValueError):
        T.exact_search_batch(tree, q, k=2, mode="fuzzy")
