"""The exact scan's k-NN pools on the device, on the CPU twins.

A device-backed partition's leaf-group loop keeps its pools on the
partition's device (``query.merger.DeviceKnnPool``) and folds each group
in with ``ops.pool_merge``; a segment, the fused ``scan_mode="kernel"``
path and a call whose k the kernel does not hold keep the host loop.
Held here:

* the device loop against the host loop on the same tree (the host loop
  taken by a k above the kernel's), against the same rows behind a
  segment (the mmap path's host loop), and against the reference's
  ``exact_knn``: ids equal; distance bits equal to both host loops and
  within rtol 1e-6 of the reference (its sums run in another order); and
  ``candidates``, ``candidates_per_query``, ``leaves_per_query``,
  ``leaves_touched``, ``scan_bytes``, ``pruned_frac``, ``leaves_scanned``
  and ``leaves_pruned`` equal to all three, at Q = 64 with one leaf a
  group and eight, Q = 8 and Q = 1 with two, k in {1, 5, 10}, with and
  without a window, and under an external bound; the ``IOStats`` charge
  equal to the host loop's; the same rows behind a tree that keeps only
  offsets into them (its raw rows gathered through the offsets) give the
  device loop the same answers and counters;
* the twin against ``merge_topk`` fed by the host loop's rule, with
  planted ties: duplicate rows (equal distances, other ids), seed rows
  found again (ids already pooled), unfilled pools (pads, and pads before
  an infinite pooled entry), infinite candidates, an external bound below
  the k-th, dead rows, and a group whose rows are all pruned;
* the pools, counts and marks round-trip through ``DeviceKnnPool.store``.

The kernel itself, and a loop that never waits on a card, are held in
``tests/test_torch_kernels.py`` (a file that imports no JAX).
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
from repro_torch.configs import SMOKE_INDEX as CFG
from repro_torch.configs import SMOKE_LEAF as LEAF
from repro_torch.core import tree as T
from repro_torch.core.metrics import IOStats
from repro_torch.kernels import ops, ref
from repro_torch.query import Partition, exact_knn
from repro_torch.query import executor as X
from repro_torch.query.merger import DeviceKnnPool, KnnPool, merge_topk
from repro_torch.storage import Segment, write_segment

N = 2000 + 37                     # a short last leaf
TS_MIN = N // 3
COUNTERS = ("candidates", "leaves_touched", "scan_bytes", "pruned_frac",
            "leaves_scanned", "leaves_pruned")
# (queries, chunk): one leaf a group at Q = 64, eight at the default chunk,
# two at Q <= 8
SHAPES = ((64, LEAF), (64, 4096), (8, 2 * LEAF), (1, 2 * LEAF))


def _walks(rng, n, length):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = np.random.default_rng(30)
    x = _walks(rng, N, CFG.series_len)
    q = _walks(rng, 64, CFG.series_len)
    q[::2] = x[rng.integers(0, N, 32)] + 0.1 * rng.standard_normal(
        (32, CFG.series_len)).astype(np.float32)
    ts = rng.permutation(N).astype(np.int32)
    tree = T.build(x, CFG, leaf_size=LEAF, timestamps=ts, device="cpu")
    lean = T.build(x, CFG, leaf_size=LEAF, timestamps=ts, device="cpu",
                   materialized=False)
    rtree = RT.build(jnp.asarray(x), RS.SummaryConfig(
        CFG.series_len, CFG.segments, CFG.bits), leaf_size=LEAF,
        timestamps=jnp.asarray(ts))
    path = str(tmp_path_factory.mktemp("pool") / "tree.coco")
    write_segment(path, tree)
    return dict(x=x, q=q, tree=tree, lean=lean, rtree=rtree,
                seg=Segment.open(path),
                bsf=rng.uniform(5.0, 40.0, 64).astype(np.float32))


def _search(env, how, nq, k, chunk, ts_min, bsf, monkeypatch, io=None):
    q = env["q"][:nq]
    bsf = None if bsf is None else bsf[:nq]
    kw = dict(k=k, ts_min=ts_min, bsf=bsf, chunk=chunk)
    if how == "reference":
        return r_exact_knn([RPartition.from_tree(env["rtree"])], q,
                           RS.SummaryConfig(CFG.series_len, CFG.segments,
                                            CFG.bits), **kw)
    if how == "segment":
        part = Partition.from_segment(env["seg"], device="cpu")
    elif how == "lean":
        part = Partition.from_tree(env["lean"])
    else:
        part = Partition.from_tree(env["tree"])
    folds = []
    merge = ops.pool_merge
    with monkeypatch.context() as m:
        if how == "host":
            m.setattr(ops, "POOL_MAX_K", 0)
        m.setattr(ops, "pool_merge",
                  lambda *a, **kw: folds.append(1) or merge(*a, **kw))
        out = exact_knn([part], q, CFG, io=io, **kw)
    assert bool(folds) == (how in ("device", "lean")
                           and out[2].leaves_scanned > 0)
    return out


def _same_stats(a, b):
    for name in COUNTERS:
        assert getattr(a, name) == getattr(b, name), name
    np.testing.assert_array_equal(a.candidates_per_query,
                                  b.candidates_per_query)
    np.testing.assert_array_equal(a.leaves_per_query, b.leaves_per_query)


@pytest.mark.parametrize("bsf", [False, True])
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("k", [1, 5, 10])
@pytest.mark.parametrize("nq,chunk", SHAPES)
def test_device_loop_equals_host_loops_and_reference(env, nq, chunk, k,
                                                     window, bsf,
                                                     monkeypatch):
    args = (nq, k, chunk, TS_MIN if window else None,
            env["bsf"] if bsf else None, monkeypatch)
    d, o, st = _search(env, "device", *args)
    assert st.leaves_scanned > 0
    for how in ("host", "segment", "lean"):
        hd, ho, hst = _search(env, how, *args)
        np.testing.assert_array_equal(o, ho, err_msg=how)
        np.testing.assert_array_equal(_bits(d), _bits(hd), err_msg=how)
        _same_stats(st, hst)
    rd, ro, rst = _search(env, "reference", *args)
    np.testing.assert_array_equal(o, ro)
    np.testing.assert_allclose(d, rd, rtol=1e-6)
    _same_stats(st, rst)


def test_device_loop_charges_io_as_the_host_loop(env, monkeypatch):
    ios = {}
    for how in ("device", "host"):
        ios[how] = IOStats()
        _search(env, how, 64, LEAF, 10, TS_MIN, None, monkeypatch,
                io=ios[how])
    assert ios["device"].as_dict() == ios["host"].as_dict()
    assert ios["device"].counters["seq_read_blocks"] > 0


def test_large_k_keeps_the_host_loop(env, monkeypatch):
    k = ops.POOL_MAX_K + 1
    calls = []
    monkeypatch.setattr(X, "_scan_device",
                        lambda *a, **kw: calls.append(1))
    d, o, st = exact_knn([Partition.from_tree(env["tree"])], env["q"][:2],
                         CFG, k=k)
    assert not calls and st.leaves_scanned > 0
    assert np.isfinite(d).all() and (np.sort(o, 1)[:, 1:]
                                     != np.sort(o, 1)[:, :-1]).all()


# ---------------------------------------------------------------------------
# the twin against merge_topk
# ---------------------------------------------------------------------------

def _fold_by_host(md, dd, leaves, leaf, dead, ids, best_d, best_off, ext):
    """The host loop's rule, one query at a time through merge_topk."""
    nq, b = md.shape
    k = best_d.shape[1]
    rows = leaves[np.arange(b) // leaf] * leaf + np.arange(b) % leaf
    live = md < np.minimum(best_d[:, -1], ext)[:, None]
    if dead is not None:
        live &= ~dead[rows]
    best_d, best_off = best_d.copy(), best_off.copy()
    for qi in range(nq):
        if live[qi].any():
            best_d[qi], best_off[qi] = merge_topk(
                np.concatenate([best_d[qi], dd[qi][live[qi]]]),
                np.concatenate([best_off[qi], ids[rows[live[qi]]]]), k)
    return best_d, best_off, live, rows


def _planted(seed, nq, k, n_leaves, leaf, b_leaves):
    """Pools and one group with the ties the contract orders."""
    rng = np.random.default_rng(seed)
    n = n_leaves * leaf - 3
    ids = rng.permutation(10 * n)[:n].astype(np.int64)
    leaves = np.sort(rng.choice(n_leaves, b_leaves, replace=False))
    if leaves[-1] == n_leaves - 1:
        b = (b_leaves - 1) * leaf + leaf - 3
    else:
        b = b_leaves * leaf
    rows = leaves[np.arange(b) // leaf] * leaf + np.arange(b) % leaf
    # distances on a coarse grid, so equal distances are common
    dd = rng.integers(0, 40, (nq, b)).astype(np.float32) / 4
    dd[:, ::7] = dd[:, ::7][:, :1]                  # duplicate rows
    dd[rng.random((nq, b)) < 0.02] = np.inf         # infinite candidates
    md = np.minimum(dd, rng.uniform(0, 12, (nq, b)).astype(np.float32))
    best_d = np.full((nq, k), np.inf, np.float32)
    best_off = np.full((nq, k), -1, np.int64)
    for qi in range(nq):
        fill = [k, k, k - 1, 0, max(k // 2, 1)][qi % 5]
        # seed rows found again (pooled ids of the group, same distances)
        # beside rows of other partitions
        again = rng.choice(b, min(b, (fill + 1) // 2), replace=False)
        fresh = fill - len(again)
        if fill:
            best_d[qi], best_off[qi] = merge_topk(
                np.concatenate([dd[qi, again],
                                rng.integers(0, 40, fresh) / 4]),
                np.concatenate([ids[rows[again]],
                                rng.integers(10 * n, 11 * n, fresh)]), k)
        elif k >= 3:                     # pads before an infinite entry
            best_d[qi, 2], best_off[qi, 2] = np.inf, 10 * n + 1
    ext = np.full(nq, np.inf, np.float32)
    ext[::3] = rng.uniform(0, 6, len(ext[::3]))     # below the k-th
    dead = rng.random(n) < 0.2
    return dict(md=md, dd=dd, leaves=leaves, leaf=leaf, dead=dead, ids=ids,
                best_d=best_d, best_off=best_off, ext=ext, n=n,
                n_leaves=n_leaves)


def _twin(p, dead=True):
    t = {name: torch.from_numpy(np.array(p[name]))
         for name in ("md", "dd", "leaves", "ids", "best_d", "best_off",
                      "ext")}
    t["dead"] = torch.from_numpy(p["dead"]) if dead else None
    nq = p["md"].shape[0]
    t["counts"] = torch.zeros(nq, dtype=torch.int64)
    t["row_mark"] = torch.zeros(p["n_leaves"] * p["leaf"], dtype=torch.uint8)
    t["leaf_mark"] = torch.zeros((nq, p["n_leaves"]), dtype=torch.uint8)
    ref.pool_merge_ref(t["md"], t["dd"], t["leaves"], p["leaf"], t["dead"],
                       t["ids"], t["best_d"], t["best_off"], t["ext"],
                       t["counts"], t["row_mark"], t["leaf_mark"])
    return t


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("k", [1, 3, 10, 64])
@pytest.mark.parametrize("b_leaves", [1, 2, 5])
def test_twin_is_merge_topk(k, b_leaves, dead):
    p = _planted(k * 10 + b_leaves, 23, k, 9, 50, b_leaves)
    t = _twin(p, dead)
    want_d, want_o, live, rows = _fold_by_host(
        p["md"], p["dd"], p["leaves"], p["leaf"],
        p["dead"] if dead else None, p["ids"], p["best_d"], p["best_off"],
        p["ext"])
    np.testing.assert_array_equal(_bits(t["best_d"].numpy()), _bits(want_d))
    np.testing.assert_array_equal(t["best_off"].numpy(), want_o)
    np.testing.assert_array_equal(t["counts"].numpy(), live.sum(1))
    want_rows = np.zeros(p["n_leaves"] * p["leaf"], np.uint8)
    want_rows[rows[live.any(0)]] = 1
    np.testing.assert_array_equal(t["row_mark"].numpy(), want_rows)
    want_leaves = np.zeros((23, p["n_leaves"]), np.uint8)
    for qi in range(23):
        want_leaves[qi, rows[live[qi]] // p["leaf"]] = 1
    np.testing.assert_array_equal(t["leaf_mark"].numpy(), want_leaves)
    assert live.any() and not live.all()


def test_twin_leaves_pools_without_live_rows_alone():
    p = _planted(5, 10, 4, 4, 50, 1)
    p["md"][:] = np.inf                              # every pair pruned
    # an unsorted-looking pool the host merge would rewrite: kept as is
    p["best_d"][0] = [np.inf, np.inf, np.inf, np.inf]
    p["best_off"][0] = [-1, -1, 7, -1]
    t = _twin(p)
    np.testing.assert_array_equal(t["best_off"].numpy(), p["best_off"])
    np.testing.assert_array_equal(_bits(t["best_d"].numpy()),
                                  _bits(p["best_d"]))
    assert not t["counts"].any() and not t["row_mark"].any()


def test_device_pool_round_trip():
    nq, k, n_leaves, leaf = 5, 4, 3, 8
    rng = np.random.default_rng(2)
    pool = KnnPool(nq, k, ext=rng.uniform(0, 1, nq))
    pool.best_d = np.sort(rng.uniform(0, 1, (nq, k)), 1).astype(np.float32)
    pool.best_off = rng.integers(0, 99, (nq, k))
    dp = DeviceKnnPool(pool, torch.device("cpu"), n_leaves=n_leaves,
                       leaf_size=leaf)
    dp.counts += torch.arange(nq)
    dp.leaf_mark[1, 2] = dp.leaf_mark[3, 0] = 1
    dp.row_mark[[0, 1, 17]] = 1
    dp.best_d[0, 0] = 0.0
    want_d = dp.best_d.numpy().copy()
    live, leaves, verified = dp.store(pool)
    np.testing.assert_array_equal(pool.best_d, want_d)
    assert pool.best_off.dtype == np.int64 and pool.best_d.dtype == np.float32
    np.testing.assert_array_equal(live, np.arange(nq))
    np.testing.assert_array_equal(leaves, [0, 1, 0, 1, 0])
    np.testing.assert_array_equal(verified, [2, 0, 1])
