"""Port parity: the one-launch device-resident sharded scan (the scan mesh,
the pinning plan, ``ops.mesh_scan`` and its twins, ``MeshScanEngine``
and the sharded engine's ``scan_mode="mesh"``), PyTorch (CPU twins) vs
the JAX reference.

On the CPU a mesh is a list of CPU devices, so D = 1, 2 and 4 run in one
process; the per-device body is the plain twin ``local_scan_topk`` (the
``scan_verify`` kernel's launches per sub-shard are held on the card by
``chip_smoke.py``).  Tolerances: layouts, ids, counts and fallback
counters exact; distances at rtol 1e-6 with atol 1e-6 against the
reference (float32 sums ordered differently by XLA and torch); within the
port, the mesh and the threaded fan-out, every D, and the launch and its
twin agree bit for bit.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import summarization as RS
from repro.distributed import sharded_lsm as RSL
from repro.kernels import ref as RREF
from repro.query import planner as RP
from repro_torch.configs import SMOKE_INDEX as CFG
from repro_torch.configs import SMOKE_LEAF as LEAF
from repro_torch.core import summarization as S
from repro_torch.distributed.sharded_lsm import ShardedCoconutLSM
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import SCAN_AXIS, make_scan_mesh
from repro_torch.obs import get_registry
from repro_torch.query import Budget
from repro_torch.query.mesh import MeshScanEngine
from repro_torch.query.planner import build_device_layout
from repro_torch.storage import TieredLeafStore

L, W, B = CFG.series_len, CFG.segments, CFG.bits
RCFG = RS.SummaryConfig(L, W, B)
TOL = dict(rtol=1e-6, atol=1e-6)
CPU = torch.device("cpu")
I32_MIN = np.iinfo(np.int32).min


def _walks(rng, n, length=L):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _same_bits(a, b, what=""):
    (d1, o1), (d2, o2) = a, b
    np.testing.assert_array_equal(o1, o2, err_msg=what)
    np.testing.assert_array_equal(_bits(d1), _bits(d2), err_msg=what)


def _counter(name):
    return get_registry().counter(name).value


# ------------------------------------------------------------ layout, mesh

@pytest.mark.parametrize("rows,devs,bucket", [
    ((0,), 1, 2048), ((5000,), 4, 2048), ((10, 4097, 0, 3), 4, 2048),
    ((10, 20, 30), 2, 16), ((1, 2, 3, 4, 5, 6), 4, 64),
    ((100, 100, 100, 100), 3, 32)])
def test_device_layout_equals_reference(rows, devs, bucket):
    got = build_device_layout(rows, n_devices=devs, bucket=bucket)
    want = RP.build_device_layout(rows, n_devices=devs, bucket=bucket)
    for f in ("n_shards", "n_devices", "shards_per_device", "cap",
              "row_counts", "padded_rows", "pad_frac"):
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError):
        build_device_layout((), n_devices=1)


def test_scan_mesh_spans_largest_divisor(monkeypatch):
    monkeypatch.delenv("COCONUT_MESH_DEVICES", raising=False)
    four = [CPU] * 4
    for s, d in ((1, 1), (2, 2), (3, 3), (4, 4), (6, 3), (8, 4), (7, 1)):
        assert len(make_scan_mesh(s, devices=four)) == d, s
    monkeypatch.setenv("COCONUT_MESH_DEVICES", "2")
    assert len(make_scan_mesh(4, devices=four)) == 2
    assert len(make_scan_mesh(3, devices=four)) == 1
    with pytest.raises(ValueError):
        make_scan_mesh(0, devices=four)
    assert SCAN_AXIS == "shard"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_scan_mesh(2)


# ------------------------------------------------------- the launch, twins

def _stacks(seed, s=4, cap=192, nq=5):
    rng = np.random.default_rng(seed)
    raw = _walks(rng, s * cap).reshape(s, cap, L)
    q = _walks(rng, nq)
    q[0] = raw[1, 7] + 0.05
    paas, codes = S.summarize(torch.from_numpy(raw.reshape(-1, L)), CFG)
    codes = codes.numpy().reshape(s, cap, W)
    ids = rng.permutation(s * cap).astype(np.int32).reshape(s, cap)
    fill = [cap, cap - 50, 0, cap - 1][:s] + [cap] * max(0, s - 4)
    for si, f in enumerate(fill):
        ids[si, f:] = -1                 # padding rows
    ts = rng.integers(0, 1000, (s, cap)).astype(np.int32)
    ts_min = np.asarray([100, I32_MIN, 500, 0][:s] + [0] * max(0, s - 4),
                        np.int32)
    q_paas = S.paa(torch.from_numpy(q), W).numpy()
    ed = ((raw.reshape(-1, L)[None] - q[:, None]) ** 2).sum(-1)
    bound = np.sort(ed, axis=1)[:, 40].astype(np.float32)
    bound[1] = np.inf
    return q, q_paas, codes, raw, ids, ts, ts_min, bound


def test_mesh_scan_ref_matches_reference():
    lower, upper = S.region_bounds(B)
    rlo, rhi = RS.region_bounds(B)
    for k in (1, 4):
        q, qp, codes, raw, ids, ts, ts_min, bound = _stacks(1)
        t = [torch.from_numpy(a) for a in (q, qp, codes, raw, ids, ts,
                                           ts_min, bound)]
        d, o, c = ref.mesh_scan_ref(*t, lower, upper, scale=L / W, k=k)
        rd, ro, rc = RREF.mesh_scan_ref(
            *(jnp.asarray(a) for a in (q, qp, codes, raw, ids, ts, ts_min,
                                       bound)), rlo, rhi, scale=L / W, k=k)
        np.testing.assert_array_equal(o.numpy(), np.asarray(ro))
        np.testing.assert_allclose(d.numpy(), np.asarray(rd), **TOL)
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
        assert (o.numpy()[1] >= 0).all()          # unbounded query
    # the blocked cross form: the reference's values, and one row's bits
    # whatever rows share the call
    flat = torch.from_numpy(raw.reshape(-1, L))
    got = ref.batch_euclid_blocked_ref(torch.from_numpy(q), flat)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(RREF.batch_euclid_blocked_ref(
            jnp.asarray(q), jnp.asarray(raw.reshape(-1, L)))), **TOL)
    np.testing.assert_array_equal(
        _bits(ref.batch_euclid_blocked_ref(torch.from_numpy(q),
                                           flat[100:613]).numpy()),
        _bits(got.numpy()[:, 100:613]))


@pytest.mark.parametrize("devices", [1, 2, 4])
def test_ops_mesh_scan_over_cpu_meshes_equals_twin(devices):
    lower, upper = S.region_bounds(B)
    q, qp, codes, raw, ids, ts, ts_min, bound = _stacks(2)
    spd = 4 // devices
    blocks = [[torch.from_numpy(a[j * spd:(j + 1) * spd])
               for j in range(devices)] for a in (codes, raw, ids, ts)]
    t = [torch.from_numpy(a) for a in (q, qp, codes, raw, ids, ts, ts_min,
                                       bound)]
    for k in (1, 3, 9):
        for cut in (ts_min, None):
            got = ops.mesh_scan(
                t[0], t[1], *blocks,
                None if cut is None else torch.from_numpy(cut), t[7], CFG,
                k=k)
            tm = t[6] if cut is not None else torch.full((4,), I32_MIN,
                                                         dtype=torch.int32)
            want = ref.mesh_scan_ref(t[0], t[1], t[2], t[3], t[4], t[5],
                                     tm, t[7], lower, upper, scale=L / W,
                                     k=k)
            _same_bits((got[0].numpy(), got[1].numpy()),
                       (want[0].numpy(), want[1].numpy()),
                       f"D={devices} k={k} window={cut is not None}")
            np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())


# ------------------------------------------------- the engine's mesh mode

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    raw = _walks(rng, 2400)
    q = _walks(rng, 6)
    q[::2] = raw[rng.integers(0, len(raw), 3)] + 0.1 * \
        rng.standard_normal((3, L)).astype(np.float32)
    return raw, q


def _port(shards=4, **kw):
    kw.setdefault("buffer_capacity", 256)
    return ShardedCoconutLSM(CFG, shards=shards, leaf_size=LEAF,
                             device="cpu", **kw)


def _fill(eng, raw, size=211):
    for s in range(0, len(raw), size):
        eng.insert(raw[s:s + size])
    eng.flush()
    return eng


@pytest.fixture(scope="module")
def engines(data):
    raw, _ = data
    port = _fill(_port(4, scan_mode="mesh"), raw)
    reference = _fill(RSL.ShardedCoconutLSM(
        RCFG, shards=4, buffer_capacity=256, leaf_size=LEAF,
        scan_mode="mesh"), raw)
    return port, reference


@pytest.mark.parametrize("devices", [1, 2, 4])
def test_mesh_equals_threaded_bitwise(data, engines, devices):
    raw, queries = data
    eng, reference = engines
    eng._mesh_engine = MeshScanEngine(CFG, devices=[CPU] * devices)
    fb0, ln0 = (_counter("query.mesh_fallbacks_total"),
                _counter("query.mesh_launches_total"))
    for k in (1, 3):
        for window in (None, 700):
            m = eng.search_exact_batch(queries, k=k, window=window)
            t = eng.search_exact_batch(queries, k=k, window=window,
                                       scan_mode="threaded")
            assert m[2]["scan_mode"] == "mesh"
            assert m[2]["mesh_devices"] == devices
            _same_bits(m[:2], t[:2], f"D={devices} k={k} window={window}")
            r = reference.search_exact_batch(queries, k=k, window=window)
            assert r[2]["scan_mode"] == "mesh"
            np.testing.assert_array_equal(m[1], r[1])
            np.testing.assert_allclose(m[0], r[0], **TOL)
            for key in ("shards_touched", "leaves_scanned",
                        "partitions_touched", "buffer_rows", "candidates"):
                assert m[2][key] == r[2][key], key
            np.testing.assert_array_equal(m[2]["candidates_per_query"],
                                          r[2]["candidates_per_query"])
    assert _counter("query.mesh_fallbacks_total") == fb0
    assert _counter("query.mesh_launches_total") == ln0 + 4
    pinned = eng._mesh_engine.pinned
    assert pinned.layout.n_devices == devices and len(pinned.codes) \
        == devices and pinned.rows == tuple(eng.shard_sizes())
    # a second batch reuses the pinned generation
    pins = _counter("query.mesh_pins_total")
    eng.search_exact_batch(queries, k=1)
    assert _counter("query.mesh_pins_total") == pins


@pytest.mark.concurrency
@pytest.mark.timeout(300)
def test_mesh_buffers_seed_the_bound_mid_stream(data):
    """A concurrent engine mid-stream: the frozen buffers are scanned
    first and their k-th distances bound the launch; mesh == threaded."""
    raw, queries = data
    with _port(4, buffer_capacity=300, concurrent=True,
               scan_mode="mesh") as eng:
        for s in range(0, 1500, 250):
            eng.insert(raw[s:s + 250])
            m = eng.search_exact_batch(queries, k=2)
            t = eng.search_exact_batch(queries, k=2, scan_mode="threaded")
            assert m[2]["scan_mode"] == "mesh"
            _same_bits(m[:2], t[:2], f"after {s + 250} rows")
        assert m[2]["buffer_rows"] > 0


def test_mesh_fallbacks_counted_and_exact(data, engines):
    raw, queries = data
    eng, _ = engines
    eng._mesh_engine = MeshScanEngine(CFG, device="cpu")
    fb0 = _counter("query.mesh_fallbacks_total")
    ap0 = _counter("query.mesh_fallback.approx_total")
    m = eng.search_exact_batch(queries, k=3, budget=Budget(max_leaves=4))
    t = eng.search_exact_batch(queries, k=3, budget=Budget(max_leaves=4),
                               scan_mode="threaded")
    assert _counter("query.mesh_fallback.approx_total") == ap0 + 1
    assert m[2].get("scan_mode") != "mesh"
    _same_bits(m[:2], t[:2])
    un0 = _counter("query.mesh_fallback.unpinnable_total")
    eng._mesh_engine = MeshScanEngine(CFG, device="cpu", max_pin_bytes=64)
    m = eng.search_exact_batch(queries, k=4)
    assert _counter("query.mesh_fallback.unpinnable_total") == un0 + 1
    assert m[2].get("scan_mode") != "mesh"
    _same_bits(m[:2], eng.search_exact_batch(queries, k=4,
                                             scan_mode="threaded")[:2])
    assert _counter("query.mesh_fallbacks_total") == fb0 + 2
    eng._mesh_engine = MeshScanEngine(CFG, device="cpu")


def test_mesh_window_range_fallback(data):
    """Timestamps past int32: a windowed probe falls back (the pinned
    clock is int32), an unwindowed one runs on the mesh, as in the
    reference."""
    raw, queries = data
    rows = raw[:600]
    ts = np.arange(600, dtype=np.int64) + (1 << 33)
    port = _port(2, scan_mode="mesh")
    reference = RSL.ShardedCoconutLSM(RCFG, shards=2, buffer_capacity=256,
                                      leaf_size=LEAF, scan_mode="mesh")
    for eng in (port, reference):
        eng.insert(rows, ts)
        eng.flush()
    wr0 = _counter("query.mesh_fallback.window_range_total")
    m = port.search_exact_batch(queries, k=2, window=300)
    assert _counter("query.mesh_fallback.window_range_total") == wr0 + 1
    assert m[2].get("scan_mode") != "mesh"
    # the reference falls back too (its answers differ: its jax columns
    # hold int32 timestamps, which this clock overflows)
    assert reference.search_exact_batch(
        queries, k=2, window=300)[2].get("scan_mode") != "mesh"
    _same_bits(m[:2], port.search_exact_batch(
        queries, k=2, window=300, scan_mode="threaded")[:2])
    assert (m[1] >= 300).all()           # the newest 300 rows only
    m = port.search_exact_batch(queries, k=2)
    assert m[2]["scan_mode"] == "mesh"
    _same_bits(m[:2], port.search_exact_batch(
        queries, k=2, scan_mode="threaded")[:2])


def test_mesh_freshness_and_invalidation(tmp_path, data):
    """A planted row answers at d == 0 from the buffer pool and, after a
    flush, from the repinned stacks; a durable engine with tiers drops its
    pinned stacks when a flush retires a segment."""
    raw, queries = data
    eng = _fill(_port(2, scan_mode="mesh", concurrent=True), raw[:600])
    planted = (raw[700] * 3.0)[None]
    eng.insert(planted, np.asarray([600], np.int64))
    d, ids, info = eng.search_exact_batch(planted, k=1)
    assert info["scan_mode"] == "mesh" and info["buffer_rows"] == 1
    assert d[0, 0] == 0.0 and ids[0, 0] == 600
    pins = _counter("query.mesh_pins_total")
    eng.flush()
    d, ids, info = eng.search_exact_batch(planted, k=1)
    assert info["scan_mode"] == "mesh" and info["buffer_rows"] == 0
    assert d[0, 0] == 0.0 and ids[0, 0] == 600
    assert _counter("query.mesh_pins_total") == pins + 1
    eng.close()

    tiers = TieredLeafStore(1 << 22)
    dur = _port(2, buffer_capacity=128, data_dir=str(tmp_path / "d"),
                scan_mode="mesh")
    _fill(dur, raw[:600], 128)
    dur.close()
    dur = ShardedCoconutLSM.open(str(tmp_path / "d"), tiers=tiers,
                                 scan_mode="mesh", device="cpu")
    m = dur.search_exact_batch(queries, k=2)
    assert m[2]["scan_mode"] == "mesh" and dur._mesh_engine.pinned
    inv0 = _counter("query.mesh_invalidations_total")
    _fill(dur, raw[600:1000], 128)        # merges retire segments
    assert _counter("query.mesh_invalidations_total") > inv0
    assert dur._mesh_engine.pinned is None
    m = dur.search_exact_batch(queries, k=2)
    _same_bits(m[:2], dur.search_exact_batch(queries, k=2,
                                             scan_mode="threaded")[:2])
    dur.close()
