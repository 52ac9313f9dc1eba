"""Port parity: the static sharded Coconut-Tree (sample-sort bulk-load,
distributed exact, windowed and budgeted batch search, the top-k merge),
PyTorch (CPU twins, meshes of 1, 2 and 4 CPU devices) vs the JAX
reference.

The reference runs once per module in a subprocess with four forced host
devices (the device count locks at the first jax init).  Its
``build_sharded`` fails on the installed jax in its sharded summarize, so
the subprocess builds the reference's tree by hand from the reference's
own pieces, as ``build_sharded`` does: ``summarize`` and ``invsax_keys``
on the unsharded walks, the payload ``[raw, paa, codes, ts]`` in one f32
matrix, ``sharded_sort`` on it sharded over the mesh, then
``ShardedCoconutTree``.  Data: 4,096 z-normalized random walks at
(L, w, b) = (64, 8, 4), timestamps 0 .. N-1.

Tolerances: splitters, counts, keys, codes, raw rows, timestamps, answer
rows and certified flags exact; PAA and answer distances at rtol 1e-6 with
atol 1e-6 (float32 sums ordered differently by XLA and torch).  Within the
port, every shard count gives the single-device tree's rows and distance
bits, and the reference's own invariants hold (global z-order, batch ==
single, window == brute force, certified == exact, balance within 2x).
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import keys as PK
from repro_torch.core import summarization as PS
from repro_torch.core import tree as T
from repro_torch.distributed import samplesort as PSS
from repro_torch.distributed.sharded_index import (
    OVERFLOW, build_sharded, distributed_exact_search,
    distributed_exact_search_batch, sharded_tree_from_arrays)
from repro_torch.kernels import ops

REPO = Path(__file__).resolve().parents[1]
N, L, W, B = 4096, 64, 8, 4
CFG = PS.SummaryConfig(L, W, B)
SHARDS = (1, 2, 4)
K3 = 3
WINDOW = 1500                 # rows at the tail of the timestamps
BUDGET = 512
SMALL_CAP = 0.25              # a cap_factor whose buckets overflow at d = 4
TOL = dict(rtol=1e-6, atol=1e-6)
# (name, k, ts_min, budget) of each search the oracle runs at d = 2 and 4
SEARCHES = (("k1", 1, None, None), ("k3", K3, None, None),
            ("window", K3, N - WINDOW, None), ("budget", K3, None, BUDGET))

ORACLE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core import keys as K, summarization as S
from repro.distributed.samplesort import local_topk_merge, sharded_sort
from repro.distributed.sharded_index import (
    ShardedCoconutTree, distributed_exact_search_batch)

inp = np.load(sys.argv[1])
raw, q, ts = inp["raw"], inp["q"], inp["ts"]
L, W, B = (int(v) for v in inp["cfg"])
cfg = S.SummaryConfig(series_len=L, segments=W, bits=B)
searches = [(str(n), int(k), None if t < 0 else int(t), None if b < 0
             else int(b)) for n, k, t, b in zip(inp["s_names"], inp["s_k"],
                                                  inp["s_ts"], inp["s_b"])]
paas, codes = S.summarize(jnp.asarray(raw), cfg)
keys = S.invsax_keys(codes, cfg)
pay = jnp.concatenate([jnp.asarray(raw), paas, codes.astype(jnp.float32),
                       jnp.asarray(ts, jnp.float32)[:, None]], axis=1)
out = {"keys": np.asarray(keys), "pay": np.asarray(pay)}


def mesh_of(d):
    return Mesh(np.array(jax.devices()[:d]), ("data",))


# each reference call runs under one jax.jit: one compile per call instead
# of one per operation of the shard_map body (the same arrays out)
def sort(d, cap_factor):
    sh = NamedSharding(mesh_of(d), P("data", None))
    fn = jax.jit(lambda k, p: sharded_sort(mesh_of(d), k, p,
                                           cap_factor=cap_factor))
    return fn(jax.device_put(keys, sh), jax.device_put(pay, sh))


for d in (1, 2, 4):
    sk, sp, counts = sort(d, 2.0)
    out[f"d{d}_keys"], out[f"d{d}_pay"] = np.asarray(sk), np.asarray(sp)
    out[f"d{d}_counts"] = np.asarray(counts)
    # the splitters sharded_sort takes (samplesort.py:92-98), from the
    # reference's own local sort of each input block
    nl = len(raw) // d
    step = max(nl // d, 1)
    blocks = [keys[i * nl:(i + 1) * nl] for i in range(d)]
    flat = jnp.concatenate([b[K.lexsort_keys(b)][::step][:d]
                            for b in blocks])
    out[f"d{d}_splitters"] = np.asarray(flat[K.lexsort_keys(flat)][d::d]
                                        [:d - 1])
    if d == 1:
        continue
    tree = ShardedCoconutTree(
        keys=sk, raw=sp[:, :L], paas=sp[:, L:L + W],
        codes=sp[:, L + W:L + 2 * W].astype(jnp.uint8), ts=sp[:, L + 2 * W],
        counts=counts, cfg=cfg, mesh=mesh_of(d), axis="data")
    for name, k, ts_min, budget in searches:
        fn = jax.jit(lambda x: distributed_exact_search_batch(
            tree, x, k=k, ts_min=ts_min, budget=budget))
        res = fn(jnp.asarray(q))
        for tag, v in zip(("d", "rows", "cert"), res):
            out[f"d{d}_{name}_{tag}"] = np.asarray(v)

sk, sp, counts = sort(4, float(inp["small_cap"]))
out["over_keys"], out["over_pay"] = np.asarray(sk), np.asarray(sp)
out["over_counts"] = np.asarray(counts)

sh = NamedSharding(mesh_of(4), P("data"))
fn = jax.jit(lambda a, b: local_topk_merge(mesh_of(4), a, b, int(inp["m_k"])))
md, mi = fn(jax.device_put(inp["m_d"], sh), jax.device_put(inp["m_i"], sh))
out["merge_d"], out["merge_i"] = np.asarray(md), np.asarray(mi)
np.savez(sys.argv[2], **out)
print("ORACLE_OK")
"""


def _walks(rng, n, length):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    raw = _walks(rng, N, L)
    q = _walks(rng, 6, L)
    q[::2] = raw[[123, 2048, 4000]] + 0.1 * rng.standard_normal(
        (3, L)).astype(np.float32)
    ts = np.arange(N, dtype=np.int64)
    # merge inputs with ties: values on a coarse grid
    m_d = np.round(rng.random(N), 2).astype(np.float32)
    return raw, q, ts, m_d


@pytest.fixture(scope="module")
def oracle(data, tmp_path_factory):
    raw, q, ts, m_d = data
    work = tmp_path_factory.mktemp("sharded_oracle")
    inp, outp = work / "in.npz", work / "out.npz"
    np.savez(inp, raw=raw, q=q, ts=ts, cfg=np.array([L, W, B]),
             s_names=np.array([s[0] for s in SEARCHES]),
             s_k=np.array([s[1] for s in SEARCHES]),
             s_ts=np.array([-1 if s[2] is None else s[2] for s in SEARCHES]),
             s_b=np.array([-1 if s[3] is None else s[3] for s in SEARCHES]),
             small_cap=SMALL_CAP, m_d=m_d, m_i=np.arange(N, dtype=np.int32),
             m_k=np.int32(5))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(ORACLE),
                        str(inp), str(outp)], capture_output=True, text=True,
                       timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0 and "ORACLE_OK" in r.stdout, \
        f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(outp))


@pytest.fixture(scope="module")
def trees(data):
    raw, _, ts, _ = data
    return {d: build_sharded(["cpu"] * d, raw, CFG, timestamps=ts)
            for d in SHARDS}


def _ref_shards(flat, counts):
    """The valid rows of each shard of a reference (padded) array."""
    m = len(flat) // len(counts)
    return [flat[j * m: j * m + (c if c >= 0 else -c - 1)]
            for j, c in enumerate(counts)]


def _i64(keys_u32):
    return torch.from_numpy(np.asarray(keys_u32, np.uint32).astype(np.int64))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _np(t):
    return t.cpu().numpy()


# ------------------------------------------------------------ the sort

@pytest.mark.parametrize("d", SHARDS)
def test_sharded_sort_equals_reference(oracle, d):
    """On the reference's own keys and payload: the same splitters,
    counts, and each shard's valid keys and payload rows, bit for bit."""
    mesh = ["cpu"] * d
    keys, pay = _i64(oracle["keys"]), torch.from_numpy(oracle["pay"])
    sk, sp, counts = PSS.sharded_sort(mesh, keys, pay)
    want_c = oracle[f"d{d}_counts"]
    np.testing.assert_array_equal(_np(counts), want_c)
    want_k = _ref_shards(oracle[f"d{d}_keys"], want_c)
    want_p = _ref_shards(oracle[f"d{d}_pay"], want_c)
    assert len(sk) == len(sp) == d
    for j in range(d):
        np.testing.assert_array_equal(_np(sk[j]), want_k[j].astype(np.int64))
        np.testing.assert_array_equal(_bits(_np(sp[j])), _bits(want_p[j]))
    nl = N // d
    blocks = [keys[i * nl:(i + 1) * nl] for i in range(d)]
    got_s = PSS.sample_splitters([b[PK.lexsort_keys(b)] for b in blocks])
    np.testing.assert_array_equal(_np(got_s),
                                  oracle[f"d{d}_splitters"].astype(np.int64))


@pytest.mark.parametrize("d", SHARDS)
def test_build_sharded_equals_reference(oracle, trees, d):
    """The port's own build (fused_build per shard, then the sort): the
    reference's counts and each shard's keys, codes, raw rows and
    timestamps exactly, PAA within tolerance."""
    tree = trees[d]
    want_c = oracle[f"d{d}_counts"]
    np.testing.assert_array_equal(_np(tree.counts), want_c)
    assert tree.n_valid == N and tree.mesh == (torch.device("cpu"),) * d
    pay = _ref_shards(oracle[f"d{d}_pay"], want_c)
    keys = _ref_shards(oracle[f"d{d}_keys"], want_c)
    for j in range(d):
        np.testing.assert_array_equal(_np(tree.keys[j]),
                                      keys[j].astype(np.int64))
        np.testing.assert_array_equal(_np(tree.raw[j]), pay[j][:, :L])
        np.testing.assert_allclose(_np(tree.paas[j]), pay[j][:, L:L + W],
                                   **TOL)
        np.testing.assert_array_equal(_np(tree.codes[j]),
                                      pay[j][:, L + W:L + 2 * W])
        np.testing.assert_array_equal(_np(tree.ts[j]), pay[j][:, L + 2 * W])
        assert tree.codes[j].dtype == torch.uint8
        assert tree.ts[j].dtype == torch.float32


def test_overflow_counts_and_error_equal_reference(oracle, data):
    """A cap_factor whose buckets overflow: the reference's signed counts
    (``-valid - 1`` on a shard whose own rows overflowed) and surviving
    rows, and ``build_sharded``'s RuntimeError."""
    mesh = ["cpu"] * 4
    sk, sp, counts = PSS.sharded_sort(mesh, _i64(oracle["keys"]),
                                      torch.from_numpy(oracle["pay"]),
                                      cap_factor=SMALL_CAP)
    want_c = oracle["over_counts"]
    assert (want_c < 0).any()
    np.testing.assert_array_equal(_np(counts), want_c)
    for j, (wk, wp) in enumerate(zip(_ref_shards(oracle["over_keys"], want_c),
                                     _ref_shards(oracle["over_pay"], want_c))):
        np.testing.assert_array_equal(_np(sk[j]), wk.astype(np.int64))
        np.testing.assert_array_equal(_bits(_np(sp[j])), _bits(wp))
    raw, _, ts, _ = data
    with pytest.raises(RuntimeError, match="overflow"):
        build_sharded(mesh, raw, CFG, cap_factor=SMALL_CAP, timestamps=ts)
    assert "raise cap_factor" in OVERFLOW


def test_local_topk_merge_equals_reference(oracle, data):
    _, _, _, m_d = data
    d, i = PSS.local_topk_merge(["cpu"] * 4, torch.from_numpy(m_d),
                                torch.arange(N, dtype=torch.int32), 5)
    np.testing.assert_array_equal(_np(d), oracle["merge_d"])
    np.testing.assert_array_equal(_np(i), oracle["merge_i"])


# ------------------------------------------------------------ the search

def _tree_from_oracle(oracle, d):
    pay = oracle[f"d{d}_pay"]
    return sharded_tree_from_arrays(
        oracle[f"d{d}_keys"], pay[:, L + W:L + 2 * W], pay[:, L:L + W],
        pay[:, :L], oracle[f"d{d}_counts"], CFG, ["cpu"] * d,
        ts=pay[:, L + 2 * W])


@pytest.mark.parametrize("source", ["build", "arrays"])
@pytest.mark.parametrize("d", (2, 4))
@pytest.mark.parametrize("search", SEARCHES, ids=[s[0] for s in SEARCHES])
def test_search_equals_reference(oracle, trees, data, d, search, source):
    """Answer rows exact, distances within tolerance, certified flags
    exact; on the port's own tree and on the reference's arrays."""
    name, k, ts_min, budget = search
    _, q, _, _ = data
    tree = trees[d] if source == "build" else _tree_from_oracle(oracle, d)
    res = distributed_exact_search_batch(tree, q, k=k, ts_min=ts_min,
                                         budget=budget)
    assert len(res) == (2 if budget is None else 3)
    want_d = oracle[f"d{d}_{name}_d"]
    assert np.isfinite(want_d).all()
    np.testing.assert_array_equal(_np(res[1]), oracle[f"d{d}_{name}_rows"])
    np.testing.assert_allclose(_np(res[0]), want_d, **TOL)
    if budget is not None:
        np.testing.assert_array_equal(_np(res[2]),
                                      oracle[f"d{d}_{name}_cert"])


def test_from_arrays_equals_build(oracle, trees):
    """The reference's arrays cut to their counts are the port's build,
    column for column (PAA within tolerance)."""
    for d in SHARDS:
        a, b = _tree_from_oracle(oracle, d), trees[d]
        np.testing.assert_array_equal(_np(a.counts), _np(b.counts))
        for j in range(d):
            for col in ("keys", "codes", "raw", "ts"):
                assert torch.equal(getattr(a, col)[j], getattr(b, col)[j])
            np.testing.assert_allclose(_np(a.paas[j]), _np(b.paas[j]), **TOL)


# ------------------------------------- the reference's invariants, in the port

def test_global_zorder_and_count(trees, data):
    raw, _, _, _ = data
    single = T.build(raw, CFG, device="cpu")
    for d, tree in trees.items():
        assert tree.n_valid == N
        keys = torch.cat(tree.keys)
        assert not PK.key_less(keys[1:], keys[:-1]).any(), d
        # the shards end to end are the single-device stable sort
        assert torch.equal(keys, single.keys)
        assert torch.equal(torch.cat(tree.raw), single.raw)


def test_batch_equals_single_queries(trees, data):
    _, q, _, _ = data
    tree = trees[4]
    for k in (1, K3):
        d, rows = distributed_exact_search_batch(tree, q, k=k)
        for qi in range(len(q)):
            d1, r1 = distributed_exact_search(tree, q[qi], k=k)
            assert np.array_equal(_bits(_np(d1)), _bits(_np(d[qi])))
            assert torch.equal(r1, rows[qi])


@pytest.mark.parametrize("ts_min", [None, N - WINDOW])
def test_shard_counts_agree_bitwise(trees, data, ts_min):
    """d = 4 and d = 2 give d = 1's answer bits, whole and windowed, and
    the single-device tree's eager chain's."""
    raw, q, ts, _ = data
    want = distributed_exact_search_batch(trees[1], q, k=K3, ts_min=ts_min)
    for d in (2, 4):
        got = distributed_exact_search_batch(trees[d], q, k=K3,
                                             ts_min=ts_min)
        assert np.array_equal(_bits(_np(got[0])), _bits(_np(want[0])))
        assert torch.equal(got[1], want[1])
    single = T.build(raw, CFG, timestamps=ts, device="cpu")
    e_d, e_o, _ = T.exact_search_batch(single, q, k=K3, ts_min=ts_min)
    assert np.array_equal(_bits(_np(want[0])), _bits(e_d))
    assert np.array_equal(_np(want[1]), raw[e_o])


def test_window_equals_brute_force(trees, data):
    raw, q, _, _ = data
    tail = torch.from_numpy(raw[-WINDOW:])
    qt = torch.from_numpy(q)
    ed = ops.batch_euclid_multi(qt, tail)                    # [Q, WINDOW]
    bd, bi = torch.sort(ed, dim=1, stable=True)
    d, rows = distributed_exact_search_batch(trees[4], q, k=K3,
                                             ts_min=N - WINDOW)
    assert torch.equal(d, bd[:, :K3])
    assert torch.equal(rows, tail[bi[:, :K3]])


@pytest.mark.parametrize("budget", [K3, 64, BUDGET, 2 * N])
def test_certified_budget_equals_exact(trees, data, budget):
    """A certified answer is the exact answer, bit for bit; no budgeted
    answer beats the exact one; a budget past every shard's rows (as if
    padded with +inf bounds) is certified and exact."""
    _, q, _, _ = data
    full_d, full_r = distributed_exact_search_batch(trees[4], q, k=K3)
    d, rows, cert = distributed_exact_search_batch(trees[4], q, k=K3,
                                                   budget=budget)
    assert (d >= full_d).all()
    c = cert.numpy()
    assert np.array_equal(_bits(_np(d))[c], _bits(_np(full_d))[c])
    assert torch.equal(rows[cert], full_r[cert])
    if budget > N:
        assert c.all()
    with pytest.raises(ValueError, match="budget"):
        distributed_exact_search_batch(trees[4], q, k=K3, budget=K3 - 1)


def test_ts_min_needs_timestamps(data):
    raw, q, _, _ = data
    tree = build_sharded(["cpu"] * 2, raw, CFG)
    assert tree.ts is None
    with pytest.raises(ValueError, match="timestamps"):
        distributed_exact_search_batch(tree, q, k=1, ts_min=0)
    with pytest.raises(ValueError, match="divide"):
        build_sharded(["cpu"] * 3, raw[:100], CFG)


def test_samplesort_balance():
    """Splitter sampling keeps partitions within 2x of ideal (8,192
    walks, 8 shards, L = 32)."""
    raw = _walks(np.random.default_rng(1), 8192, 32)
    cfg = PS.SummaryConfig(32, 8, 4)
    tree = build_sharded(["cpu"] * 8, raw, cfg)
    counts = tree.counts.numpy()
    assert counts.sum() == 8192 and (counts >= 0).all()
    assert counts.max() <= 2 * 8192 // 8, counts
