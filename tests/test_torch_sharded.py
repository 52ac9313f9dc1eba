"""Port parity: the sharded Coconut-LSM (key-range router, threaded
fan-out, shared backpressure, sharded store, rebalance), PyTorch (CPU
twins) vs the JAX reference.

Both packages get the same numpy batches (the smoke config: L=64, w=8,
b=4, leaf 64; 1,600 random walks).  Tolerances: router keys, splitters,
routes, reservoirs, fence envelopes and fence bounds bit-exact; shard
sizes, answer ids, ``shards_touched``/``shards_pruned`` and every other
count exact; answer distances at rtol 1e-6 with atol 1e-6 against the
reference (float32 sums ordered differently by XLA and torch); within the
port, every shard count, the single ``CoconutLSM``, concurrent ingest,
rebalance and reopen give the same distance bits; ``SHARDS.json`` and
the shard manifests byte for byte.
"""
from __future__ import annotations

import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsm as RL
from repro.core import summarization as RS
from repro.distributed import router as RR
from repro.distributed import samplesort as RSS
from repro.distributed import sharded_lsm as RSL
from repro.query import Budget as RBudget
from repro_torch.configs import SMOKE_INDEX as CFG
from repro_torch.configs import SMOKE_LEAF as LEAF
from repro_torch.core import keys as PK
from repro_torch.core.lsm import CoconutLSM
from repro_torch.core.windows import window_engine
from repro_torch.distributed import router as PR
from repro_torch.distributed import samplesort as PSS
from repro_torch.distributed import sharded_lsm as PSL
from repro_torch.distributed.sharded_lsm import ShardedCoconutLSM
from repro_torch.query import Budget

N = 1600
NQ = 6
L = CFG.series_len
RCFG = RS.SummaryConfig(CFG.series_len, CFG.segments, CFG.bits)
TOL = dict(rtol=1e-6, atol=1e-6)
CAP = 256


def _walks(rng, n, length):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    raw = _walks(rng, N, L)
    q = _walks(rng, NQ, L)
    q[::2] = raw[rng.integers(0, N, (NQ + 1) // 2)] + 0.1 * \
        rng.standard_normal(((NQ + 1) // 2, L)).astype(np.float32)
    return raw, q


def _batches(raw, size=173):
    for s in range(0, len(raw), size):
        yield raw[s: s + size]


def _fill(engine, raw, size=173):
    for b in _batches(raw, size):
        engine.insert(b)
    engine.flush()
    return engine


def _port(shards, **kw):
    kw.setdefault("buffer_capacity", CAP)
    return ShardedCoconutLSM(CFG, shards=shards, leaf_size=LEAF,
                             device="cpu", **kw)


def _ref(shards, **kw):
    kw.setdefault("buffer_capacity", CAP)
    return RSL.ShardedCoconutLSM(RCFG, shards=shards, leaf_size=LEAF, **kw)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _same_bits(a, b, what=""):
    (d1, o1), (d2, o2) = a, b
    np.testing.assert_array_equal(o1, o2, err_msg=what)
    np.testing.assert_array_equal(_bits(d1), _bits(d2), err_msg=what)


def _same_as_ref(p, r, keys=("shards_touched", "shards_pruned",
                             "partitions_touched", "buffer_rows",
                             "leaves_scanned", "leaves_pruned")):
    (pd, po, pi), (rd, ro, ri) = p, r
    np.testing.assert_array_equal(po, ro)
    np.testing.assert_allclose(pd, rd, **TOL)
    for key in keys:
        assert pi[key] == ri[key], (key, pi[key], ri[key])


@pytest.fixture(scope="module")
def engines(data):
    raw, _ = data
    single = _fill(CoconutLSM(CFG, buffer_capacity=CAP, leaf_size=LEAF,
                              device="cpu"), raw)
    port = {s: _fill(_port(s), raw) for s in (1, 2, 4)}
    ref = {s: _fill(_ref(s), raw) for s in (1, 2, 4)}
    return single, port, ref


# ----------------------------------------------------------------- router

def test_router_keys_splitters_routes_equal_reference(data):
    raw, _ = data
    keys = PR.batch_keys(raw, CFG, "cpu")
    rkeys = RR.batch_keys(raw, RCFG)
    assert keys.dtype == np.uint32
    np.testing.assert_array_equal(keys, rkeys)
    for d in (1, 2, 3, 4, 8):
        np.testing.assert_array_equal(
            PSS.splitters_from_sample(keys, d),
            RSS.splitters_from_sample(rkeys, d))
    pr, rr = PR.KeyRangeRouter(CFG, 4, sample_cap=512), \
        RR.KeyRangeRouter(RCFG, 4, sample_cap=512)
    assert pr.ensure_boundaries(keys[:300]) and \
        rr.ensure_boundaries(rkeys[:300])
    np.testing.assert_array_equal(pr.boundaries, rr.boundaries)
    # every key, the boundaries themselves and their neighbours
    probe = np.concatenate([keys, pr.boundaries, pr.boundaries - 1,
                            pr.boundaries + 1]).astype(np.uint32)
    np.testing.assert_array_equal(pr.route(probe), rr.route(probe))
    for s in range(0, N, 400):          # the reservoir fills, then replaces
        pr.observe(keys[s:s + 400])
        rr.observe(rkeys[s:s + 400])
    np.testing.assert_array_equal(pr._sample, rr._sample)
    np.testing.assert_array_equal(pr.reestimate(), rr.reestimate())
    np.testing.assert_array_equal(pr.shard_shares(), rr.shard_shares())
    assert pr.boundaries_json() == rr.boundaries_json()
    back = PR.KeyRangeRouter.boundaries_from_json(pr.boundaries_json())
    np.testing.assert_array_equal(back, pr.boundaries)
    lo, hi = PR.key_fence_of(keys[100:700])
    assert (lo, hi) == RR.key_fence_of(rkeys[100:700])


def test_fence_bounds_bits_equal_reference_and_bound(data):
    raw, queries = data
    keys = PR.batch_keys(raw, CFG, "cpu")
    order = PK.lexsort_keys_np(keys)
    q_paas = np.asarray(RS.paa(jnp.asarray(queries), CFG.segments))
    for a, b in ((0, N), (200, 700), (1500, 1510), (5, 6)):
        chunk = order[a:b]
        lo, hi = PR.key_fence_of(keys[chunk])
        clo, chi = PR.key_range_code_bounds(lo, hi, CFG)
        rlo, rhi = RR.key_range_code_bounds(lo, hi, RCFG)
        np.testing.assert_array_equal(clo, rlo)
        np.testing.assert_array_equal(chi, rhi)
        got = PR.fence_mindist_sq(q_paas, clo, chi, CFG)
        np.testing.assert_array_equal(
            _bits(got), _bits(RR.fence_mindist_sq(q_paas, rlo, rhi, RCFG)))
        ed = ((raw[chunk][None].astype(np.float64)
               - queries[:, None]) ** 2).sum(-1)
        assert np.all(got[:, None] <= ed * (1 + 1e-5) + 1e-5)


# ------------------------------------------------------------ exact fan-out

@pytest.mark.parametrize("shards", [1, 2, 4])
def test_exact_parity_with_reference_and_single_engine(data, engines,
                                                       shards):
    raw, queries = data
    single, port, ref = engines
    eng = port[shards]
    assert eng.shard_sizes() == ref[shards].shard_sizes()
    np.testing.assert_array_equal(eng.router.boundaries
                                  if shards > 1 else 0,
                                  ref[shards].router.boundaries
                                  if shards > 1 else 0)
    for k in (1, 3):
        p = eng.search_exact_batch(queries, k=k)
        _same_as_ref(p, ref[shards].search_exact_batch(queries, k=k))
        assert p[2]["shards_touched"] + p[2]["shards_pruned"] == shards
        assert p[2]["stats"].shards_touched == p[2]["shards_touched"]
        _same_bits(p[:2], single.search_exact_batch(queries, k=k)[:2],
                   f"shards={shards} k={k}")
    d_b, o_b, _ = eng.search_exact_batch(queries, k=3)
    _same_bits(eng.search_exact_batch(torch.from_numpy(queries), k=3)[:2],
               (d_b, o_b), "tensor queries")
    for qi in (0, NQ - 1):
        d1, o1, _ = eng.search_exact(queries[qi], k=3)
        _same_bits((d1, o1), (d_b[qi], o_b[qi]))
    # ids are global stream positions: brute force agrees
    bf = ((raw[None].astype(np.float64) - queries[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(o_b[:, 0], bf.argmin(axis=1))


@pytest.mark.parametrize("mode", ["pp", "tp", "btp"])
def test_window_parity_across_shard_counts(data, engines, mode):
    """Windows cut at the same global instant on every shard: each mode's
    sharded answers equal its single engine's bits; btp's also equal the
    reference's sharded engine (the fixture's)."""
    raw, queries = data
    single = _fill(CoconutLSM(CFG, buffer_capacity=CAP, leaf_size=LEAF,
                              mode=mode, device="cpu"), raw)
    port = _fill(window_engine(mode, CFG, buffer_capacity=CAP,
                               leaf_size=LEAF, shards=4, device="cpu"), raw)
    assert isinstance(port, ShardedCoconutLSM) and port.mode == mode
    for W in (300, 900, None):
        p = port.search_exact_batch(queries, k=2, window=W)
        _same_bits(p[:2], single.search_exact_batch(queries, k=2,
                                                    window=W)[:2],
                   f"{mode} window={W}")
        if mode == "btp":
            _same_as_ref(p, engines[2][4].search_exact_batch(
                queries, k=2, window=W))


def test_shard_prune_counters_equal_reference(data, engines):
    """Near-duplicate queries: the port prunes exactly the shards the
    reference prunes (on this data the fences rarely exclude a shard, so
    the counters are compared, not asserted positive)."""
    raw, _ = data
    _, port, ref = engines
    dup = raw[np.linspace(0, N - 1, NQ, dtype=int)] + np.float32(1e-3)
    for s in (2, 4):
        p = port[s].search_exact_batch(dup, k=1)
        r = ref[s].search_exact_batch(dup, k=1)
        _same_as_ref(p, r)
        np.testing.assert_array_equal(p[2]["candidates_per_query"],
                                      r[2]["candidates_per_query"])
        assert p[2]["stats"].shards_pruned == p[2]["shards_pruned"]


def test_approx_and_budgeted_fanout_parity(data, engines):
    raw, queries = data
    _, port, ref = engines
    for s in (2, 4):
        p = port[s].search_approx_batch(queries, k=2)
        r = ref[s].search_approx_batch(queries, k=2)
        _same_as_ref(p, r, keys=("shards_touched", "partitions_touched",
                                 "buffer_rows", "budget_exhausted"))
        np.testing.assert_allclose(p[2]["gap"], r[2]["gap"], **TOL)
        for lv in (0, 3, 40):
            p = port[s].search_exact_batch(queries, k=2,
                                           budget=Budget(max_leaves=lv))
            r = ref[s].search_exact_batch(queries, k=2,
                                          budget=RBudget(max_leaves=lv))
            _same_as_ref(p, r, keys=("shards_touched", "shards_pruned",
                                     "leaves_scanned", "budget_exhausted"))
            np.testing.assert_allclose(p[2]["gap"], r[2]["gap"], **TOL)
        d, o, info = port[s].search_approx(queries[0], k=1)
        assert d.shape == (1,) and o[0] >= 0


# --------------------------------------------------------------- rebalance

def test_rebalance_parity_keeps_answers(data):
    """A key-sorted stream piles onto the last shard; both packages
    migrate under the same re-estimated boundaries, to the same shard
    sizes, and every answer keeps its bits."""
    raw, queries = data
    skewed = raw[PK.lexsort_keys_np(PR.batch_keys(raw, CFG, "cpu"))]
    port = _fill(_port(4), skewed, 200)
    ref = _fill(_ref(4), skewed, 200)
    before = port.shard_sizes()
    assert before == ref.shard_sizes() and max(before) > 2 * N // 4
    d0 = port.search_exact_batch(queries, k=3)
    assert port.rebalance(force=True) and ref.rebalance(force=True)
    np.testing.assert_array_equal(port.router.boundaries,
                                  ref.router.boundaries)
    assert port.shard_sizes() == ref.shard_sizes()
    assert max(port.shard_sizes()) < max(before) and port.n == N
    d1 = port.search_exact_batch(queries, k=3)
    _same_bits(d1[:2], d0[:2], "rebalance")
    _same_as_ref(d1, ref.search_exact_batch(queries, k=3))
    port.check_invariants()
    assert not port.rebalance()          # balanced now: no second move


def test_snapshot_set_atomic_under_stuck_epoch(data, engines):
    _, queries = data
    single, port, _ = engines
    eng = port[2]
    with eng._state_lock:
        eng._epoch += 1                  # a batch stuck in flight
    try:
        got = eng.search_exact_batch(queries, k=1)
    finally:
        with eng._state_lock:
            eng._epoch += 1
    _same_bits(got[:2], single.search_exact_batch(queries, k=1)[:2])


# ------------------------------------------------------------- concurrency

@pytest.mark.concurrency
@pytest.mark.timeout(300)
def test_concurrent_sharded_parity(data):
    """At every interleaving point the concurrent sharded engine's
    answers equal the synchronous single engine's over the same rows."""
    raw, queries = data
    raw = raw[:1200]
    sync = CoconutLSM(CFG, buffer_capacity=128, leaf_size=LEAF,
                      device="cpu")
    with _port(3, buffer_capacity=128, concurrent=True,
               max_debt=4) as conc:
        for b in _batches(raw, 211):
            sync.insert(b)
            sync.flush()
            conc.insert(b)
            _same_bits(conc.search_exact_batch(queries, k=2)[:2],
                       sync.search_exact_batch(queries, k=2)[:2])
            _same_bits(conc.search_exact_batch(queries, k=1,
                                               window=400)[:2],
                       sync.search_exact_batch(queries, k=1,
                                               window=400)[:2])
        conc.flush()
        conc.check_invariants()
        assert conc.n == sync.n == len(raw)


@pytest.mark.concurrency
@pytest.mark.timeout(180)
def test_shared_backpressure_bounds_total_debt(data):
    """The budget is shared: total outstanding debt across shards stays
    bounded while every shard compacts concurrently (the reference's
    bound: the budget plus one unit per shard a batch touched)."""
    raw, _ = data
    raw = raw[:1000]
    with _port(3, buffer_capacity=64, concurrent=True, max_debt=2) as eng:
        seen = 0
        for b in _batches(raw, 50):
            eng.insert(b)
            seen = max(seen, eng.compaction_debt())
        assert seen <= eng.max_debt + eng.n_shards
        eng.flush()
        assert eng.n == len(raw) and eng.compaction_debt() == 0
        assert eng.ingest.get("bg_flushes") > 0


@pytest.mark.concurrency
@pytest.mark.timeout(180)
def test_search_during_sharded_ingest(data):
    raw, queries = data
    raw = raw[:1200]
    with _port(2, buffer_capacity=128, concurrent=True, max_debt=3) as eng:
        t = threading.Thread(target=lambda: [eng.insert(b)
                                             for b in _batches(raw, 64)])
        t.start()
        try:
            for _ in range(8):
                d, o, _ = eng.search_exact(queries[0])
                if np.isfinite(d[0]):
                    true = float(((raw[o[0]] - queries[0]) ** 2).sum())
                    assert abs(float(d[0]) - true) < 1e-4
        finally:
            t.join()
        eng.flush()
        d, o, _ = eng.search_exact(queries[0])
        bf = ((raw.astype(np.float64) - queries[0]) ** 2).sum(-1)
        assert int(o[0]) == bf.argmin()


# ------------------------------------------------------------- durability

def _files(root: Path):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*.json"))}


@pytest.mark.disk
def test_crash_between_manifest_commits_parity(tmp_path, data):
    """Kill between per-shard manifest commits: shard 0 flushed, shard 1
    holds its acked rows only in the WAL.  Both packages write the same
    ``SHARDS.json`` and shard manifests byte for byte, each reopens the
    other's store with every row, and the answers keep their bits."""
    raw, queries = data
    roots = {"port": tmp_path / "port", "ref": tmp_path / "ref"}
    engs = {"port": _port(2, buffer_capacity=4096,
                          data_dir=str(roots["port"])),
            "ref": _ref(2, buffer_capacity=4096,
                        data_dir=str(roots["ref"]))}
    for eng in engs.values():
        for b in _batches(raw[:1000], 200):
            eng.insert(b)
        eng._shards[0].flush()           # ONE shard commits, then crash
    # before the crash: shard 1's buffered rows are invisible to both
    _same_as_ref(engs["port"].search_exact_batch(queries, k=2),
                 engs["ref"].search_exact_batch(queries, k=2))
    boundaries = engs["port"].router.boundaries.copy()
    del engs
    assert _files(roots["port"]) == _files(roots["ref"])
    sync = _fill(CoconutLSM(CFG, buffer_capacity=CAP, leaf_size=LEAF,
                            device="cpu"), raw[:1000])
    want = sync.search_exact_batch(queries, k=2)
    for src in ("ref", "port"):
        re = ShardedCoconutLSM.open(str(roots[src]), device="cpu")
        assert re.n == 1000
        np.testing.assert_array_equal(re.router.boundaries, boundaries)
        re.flush()
        _same_bits(re.search_exact_batch(queries, k=2)[:2], want[:2],
                   f"port reopening the {src} store")
        re.insert(raw[1000:1200])        # ids continue past the max
        assert re.n == 1200
        re.close()
    rre = RSL.ShardedCoconutLSM.open(str(roots["port"]))
    assert rre.n == 1200
    rre.flush()
    rd, ro, _ = rre.search_exact_batch(queries, k=2)
    sync.insert(raw[1000:1200])
    sync.flush()
    wd, wo, _ = sync.search_exact_batch(queries, k=2)
    np.testing.assert_array_equal(ro, wo)
    np.testing.assert_allclose(rd, wd, **TOL)
    rre.close()


@pytest.mark.disk
def test_rebalance_durable_generation_swap_and_refusal(tmp_path, data):
    raw, queries = data
    skewed = raw[PK.lexsort_keys_np(PR.batch_keys(raw, CFG, "cpu"))]
    root = tmp_path / "s"
    eng = _fill(_port(2, data_dir=str(root)), skewed, 200)
    d0 = eng.search_exact_batch(queries, k=2)
    assert eng.rebalance(force=True)
    gen = set(eng._dirs)
    assert all(d.endswith("-g1") for d in gen)
    eng.close()
    with pytest.raises(ValueError, match="reopen"):
        _port(2, data_dir=str(root))
    re = ShardedCoconutLSM.open(str(root), device="cpu")
    assert set(re._dirs) == gen and re.n == N
    assert sorted(p.name for p in root.iterdir()
                  if p.is_dir()) == sorted(gen)   # old generation gone
    _same_bits(re.search_exact_batch(queries, k=2)[:2], d0[:2])
    re.close()


@pytest.mark.disk
def test_failed_migration_cleans_up_and_retries(tmp_path, data,
                                                monkeypatch):
    raw, queries = data
    skewed = raw[PK.lexsort_keys_np(PR.batch_keys(raw, CFG, "cpu"))]
    eng = _fill(_port(2, data_dir=str(tmp_path)), skewed, 200)
    d0 = eng.search_exact_batch(queries, k=2)
    real = PSL.key_fence_of
    monkeypatch.setattr(PSL, "key_fence_of", lambda keys: (_ for _ in ())
                        .throw(RuntimeError("injected mid-fill failure")))
    with pytest.raises(RuntimeError, match="injected"):
        eng.rebalance(force=True)
    monkeypatch.setattr(PSL, "key_fence_of", real)
    _same_bits(eng.search_exact_batch(queries, k=2)[:2], d0[:2])
    assert eng.rebalance(force=True) and eng.n == N
    _same_bits(eng.search_exact_batch(queries, k=2)[:2], d0[:2])
    eng.close()


@pytest.mark.disk
@pytest.mark.concurrency
@pytest.mark.timeout(180)
def test_concurrent_sharded_close_is_durable(tmp_path, data):
    raw, _ = data
    with _port(2, buffer_capacity=128, data_dir=str(tmp_path),
               concurrent=True) as eng:
        for b in _batches(raw[:500], 90):
            eng.insert(b)
    re = ShardedCoconutLSM.open(str(tmp_path), device="cpu")
    assert re.n == 500
    re.close()


# ----------------------------------------------------------- window_engine

def test_window_engine_sharding_options(tmp_path):
    with pytest.raises(ValueError, match="data_dir"):
        window_engine("btp", CFG, shards=2, store=object(), device="cpu")
    one = window_engine("btp", CFG, shards=1, data_dir=str(tmp_path / "x"),
                        device="cpu")
    assert isinstance(one, CoconutLSM) and one.store is None
    assert not (tmp_path / "x").exists()     # ignored at one shard
    two = window_engine("tp", CFG, shards=2, device="cpu")
    assert isinstance(two, ShardedCoconutLSM) and two.mode == "tp"
    rows = np.random.default_rng(1).standard_normal((300, L)).astype(
        np.float32)
    two.insert(torch.from_numpy(rows))           # a tensor goes to the host
    two.flush()
    assert two.n == 300 and two.search_exact(rows[5])[1][0] == 5
    assert all(s.device.type == "cpu" for s in two._shard_list())
    with pytest.raises(ValueError, match="shards"):
        ShardedCoconutLSM(CFG, shards=0, device="cpu")
    with pytest.raises(ValueError, match="scan_mode"):
        ShardedCoconutLSM(CFG, shards=2, scan_mode="warp", device="cpu")
