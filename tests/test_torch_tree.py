"""Port parity: Coconut-Tree build and batched exact k-NN, PyTorch (CPU
twins) vs the JAX reference, plus the port's own invariants.

Both packages get the same numpy inputs.  Tolerances: keys, codes,
offsets, answer ids and ``SearchStats`` leaf counts exact; PAA and answer
distances at rtol 1e-6 (float32 sums ordered differently); within the
port, single == batch and fused == eager bit for bit; against a float64
numpy brute force, ids exact and distances at rtol 1e-5.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import summarization as RS
from repro.core import tree as RT
from repro.query import Partition as RPartition
from repro.query import exact_knn as r_exact_knn
from repro_torch.configs import INDEX, SMOKE_INDEX, SMOKE_LEAF
from repro_torch.core import tree as T
from repro_torch.query import Partition, exact_knn

N = 2000
L = SMOKE_INDEX.series_len
TS_MIN = N // 2


def _walks(rng, n, length):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


def _rcfg(cfg):
    return RS.SummaryConfig(cfg.series_len, cfg.segments, cfg.bits)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = _walks(rng, N, L)
    q = _walks(rng, 64, L)
    q[::2] = x[rng.integers(0, N, 32)] + 0.1 * rng.standard_normal(
        (32, L)).astype(np.float32)
    ts = rng.permutation(N).astype(np.int32)
    return x, q, ts


@pytest.fixture(scope="module")
def trees(data):
    x, _, ts = data
    out = {}
    for mat in (True, False):
        rt = RT.build(jnp.asarray(x), _rcfg(SMOKE_INDEX), leaf_size=SMOKE_LEAF,
                      materialized=mat, timestamps=jnp.asarray(ts))
        pt = T.build(x, SMOKE_INDEX, leaf_size=SMOKE_LEAF, materialized=mat,
                     timestamps=ts, device="cpu")
        out[mat] = (rt, pt)
    return out


def _same_answers(r, p, rtol=1e-6):
    rd, ro, rs = r
    pd, po, ps = p
    np.testing.assert_array_equal(po, ro)
    np.testing.assert_allclose(pd, rd, rtol=rtol)
    assert ps.leaves_pruned == rs.leaves_pruned
    assert ps.leaves_scanned == rs.leaves_scanned


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("mat", [True, False])
def test_build_matches_reference(trees, mat):
    rt, pt = trees[mat]
    np.testing.assert_array_equal(pt.keys.numpy(),
                                  np.asarray(rt.keys).astype(np.int64))
    np.testing.assert_array_equal(pt.codes.numpy(), np.asarray(rt.codes))
    np.testing.assert_array_equal(pt.offsets.numpy(), np.asarray(rt.offsets))
    np.testing.assert_array_equal(pt.timestamps.numpy(),
                                  np.asarray(rt.timestamps))
    np.testing.assert_allclose(pt.paas.numpy(), np.asarray(rt.paas),
                               rtol=1e-6)
    assert pt.materialized == mat and pt.n_leaves == rt.n_leaves


def test_build_paper_config_matches_reference():
    rng = np.random.default_rng(5)
    x = _walks(rng, 2000, INDEX.series_len)
    rt = RT.build(jnp.asarray(x), _rcfg(INDEX), leaf_size=200)
    pt = T.build(torch.from_numpy(x), INDEX, leaf_size=200)
    assert pt.device.type == "cpu"          # a tensor keeps its device
    np.testing.assert_array_equal(pt.keys.numpy(),
                                  np.asarray(rt.keys).astype(np.int64))
    np.testing.assert_array_equal(pt.codes.numpy(), np.asarray(rt.codes))
    np.testing.assert_array_equal(pt.offsets.numpy(), np.asarray(rt.offsets))
    np.testing.assert_allclose(pt.paas.numpy(), np.asarray(rt.paas),
                               rtol=1e-6)
    q = x[:8] + 0.1 * rng.standard_normal((8, INDEX.series_len)).astype(
        np.float32)
    _same_answers(RT.exact_search_batch(rt, q, k=10),
                  T.exact_search_batch(pt, q, k=10))


@pytest.mark.parametrize("mat", [True, False])
@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("nq", [1, 8, 64])
@pytest.mark.parametrize("k", [1, 10])
def test_exact_search_batch_matches_reference(data, trees, k, nq, ts, mat):
    _, q, _ = data
    rt, pt = trees[mat]
    ts_min = TS_MIN if ts else None
    _same_answers(RT.exact_search_batch(rt, q[:nq], k=k, ts_min=ts_min),
                  T.exact_search_batch(pt, q[:nq], k=k, ts_min=ts_min))


def test_exact_search_external_bound_matches_reference(data, trees):
    _, q, _ = data
    rt, pt = trees[True]
    bsf = np.full(16, 30.0, np.float32)
    _same_answers(RT.exact_search_batch(rt, q[:16], k=5, bsf=bsf),
                  T.exact_search_batch(pt, q[:16], k=5, bsf=bsf))


@pytest.mark.parametrize("mat", [True, False])
def test_reference_tree_carried_across(data, trees, mat):
    """from_numpy turns a reference tree's columns into a port tree whose
    answers equal the reference's on that tree; to_numpy inverts it."""
    _, q, _ = data
    rt, _ = trees[mat]
    cols = {name: np.asarray(getattr(rt, name))
            for name in ("keys", "codes", "paas", "offsets", "raw",
                         "raw_ref", "timestamps", "ids")
            if getattr(rt, name) is not None}
    pt = T.from_numpy(cols, series_len=L, segments=SMOKE_INDEX.segments,
                      bits=SMOKE_INDEX.bits, leaf_size=SMOKE_LEAF,
                      device="cpu")
    back = T.to_numpy(pt)
    for name, v in cols.items():
        assert back[name].dtype == v.dtype
        np.testing.assert_array_equal(back[name], v)
    for k, ts_min in ((1, None), (10, TS_MIN)):
        _same_answers(RT.exact_search_batch(rt, q, k=k, ts_min=ts_min),
                      T.exact_search_batch(pt, q, k=k, ts_min=ts_min))


def test_fused_scan_matches_reference_interpret(data, trees):
    _, q, _ = data
    rt, pt = trees[True]
    rd, ro, rs = r_exact_knn([RPartition.from_tree(rt)], q[:8],
                             _rcfg(SMOKE_INDEX), k=10, scan_mode="interpret")
    pd, po, ps = exact_knn([Partition.from_tree(pt)], q[:8], SMOKE_INDEX,
                           k=10, scan_mode="kernel")
    _same_answers((rd, ro, rs), (pd, po, ps))
    assert ps.candidates == rs.candidates


def test_approx_search_batch_matches_reference(data, trees):
    _, q, _ = data
    for mat in (True, False):
        rt, pt = trees[mat]
        rd, ro, rs = RT.approx_search_batch(rt, q, k=5)
        pd, po, ps = T.approx_search_batch(pt, q, k=5)
        np.testing.assert_array_equal(po, ro)
        np.testing.assert_allclose(pd, rd, rtol=1e-6)
        assert ps.candidates == rs.candidates
        d1, o1, _ = T.approx_search(pt, q[3], k=5)
        np.testing.assert_array_equal(_bits(d1), _bits(pd[3]))
        np.testing.assert_array_equal(o1, po[3])


def test_merge_trees_matches_reference(data):
    x, _, ts = data
    parts = []
    for lo, hi in ((0, N // 3), (N // 3, N)):
        parts.append((
            RT.build(jnp.asarray(x[lo:hi]), _rcfg(SMOKE_INDEX),
                     leaf_size=SMOKE_LEAF, timestamps=jnp.asarray(ts[lo:hi])),
            T.build(x[lo:hi], SMOKE_INDEX, leaf_size=SMOKE_LEAF,
                    timestamps=ts[lo:hi], device="cpu")))
    rm = RT.merge_trees(parts[0][0], parts[1][0])
    pm = T.merge_trees(parts[0][1], parts[1][1])
    np.testing.assert_array_equal(pm.keys.numpy(),
                                  np.asarray(rm.keys).astype(np.int64))
    np.testing.assert_array_equal(pm.offsets.numpy(), np.asarray(rm.offsets))
    np.testing.assert_array_equal(pm.raw.numpy(), np.asarray(rm.raw))
    np.testing.assert_array_equal(pm.timestamps.numpy(),
                                  np.asarray(rm.timestamps))


# -- the port's own invariants ------------------------------------------------

@pytest.mark.parametrize("mat", [True, False])
@pytest.mark.parametrize("k", [1, 10])
def test_single_equals_batch_bitwise(data, trees, k, mat):
    _, q, _ = data
    _, pt = trees[mat]
    bd, bo, _ = T.exact_search_batch(pt, q, k=k)
    for qi in (0, 1, 17, 63):
        sd, so, _ = T.exact_search(pt, q[qi], k=k)
        np.testing.assert_array_equal(so, bo[qi])
        np.testing.assert_array_equal(_bits(sd), _bits(bd[qi]))


@pytest.mark.parametrize("mat", [True, False])
@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("k", [1, 10])
def test_fused_kernel_mode_equals_eager(data, trees, k, ts, mat):
    _, q, _ = data
    _, pt = trees[mat]
    ts_min = TS_MIN if ts else None
    part = [Partition.from_tree(pt)]
    ed, eo, es = exact_knn(part, q, SMOKE_INDEX, k=k, ts_min=ts_min)
    fd, fo, fs = exact_knn(part, q, SMOKE_INDEX, k=k, ts_min=ts_min,
                           scan_mode="kernel")
    np.testing.assert_array_equal(fo, eo)
    np.testing.assert_array_equal(_bits(fd), _bits(ed))
    assert (fs.leaves_scanned, fs.leaves_pruned, fs.candidates) == \
        (es.leaves_scanned, es.leaves_pruned, es.candidates)
    np.testing.assert_array_equal(fs.candidates_per_query,
                                  es.candidates_per_query)


@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("k", [1, 10])
def test_answers_match_numpy_brute_force(data, trees, k, ts):
    x, q, stamps = data
    _, pt = trees[True]
    d, o, _ = T.exact_search_batch(pt, q, k=k,
                                   ts_min=TS_MIN if ts else None)
    ed = ((x[None].astype(np.float64) - q[:, None]) ** 2).sum(-1)
    if ts:
        ed[:, stamps < TS_MIN] = np.inf
    want = np.argsort(ed, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(o, want)
    np.testing.assert_allclose(d, np.take_along_axis(ed, want, 1), rtol=1e-5)


def test_scan_mode_is_checked(data, trees):
    _, q, _ = data
    _, pt = trees[True]
    with pytest.raises(ValueError):
        exact_knn([Partition.from_tree(pt)], q[:2], SMOKE_INDEX,
                  scan_mode="pallas")


def test_budget_and_approx_mode_wait_for_their_slice(data, trees):
    _, q, _ = data
    _, pt = trees[True]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.exact_search_batch(pt, q[:2], budget=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.exact_search(pt, q[0], mode="approx")
    with pytest.raises(ValueError):
        T.exact_search_batch(pt, q[:2], mode="bogus")


def test_io_accounting_matches_reference(data):
    from repro.core.metrics import IOStats as RIOStats
    from repro_torch.core.metrics import IOStats
    x, q, _ = data
    rio, pio = RIOStats(), IOStats()
    rt = RT.build(jnp.asarray(x), _rcfg(SMOKE_INDEX), leaf_size=SMOKE_LEAF,
                  io=rio)
    pt = T.build(x, SMOKE_INDEX, leaf_size=SMOKE_LEAF, io=pio, device="cpu")
    RT.exact_search_batch(rt, q[:8], k=3, io=rio)
    T.exact_search_batch(pt, q[:8], k=3, io=pio)
    assert pio.as_dict() == rio.as_dict()
