"""Port parity: the in-memory Coconut-LSM, its snapshots, the background
compactor and the window engines, PyTorch (CPU twins) vs the JAX
reference, plus the store-less ingest battery of the reference's own
tests run on the port.

Both packages get the same numpy batches (the smoke config: L=64, w=8,
b=4, leaf 64; a few thousand random walks).  Tolerances: run sizes,
levels, time ranges, merge counts, tree keys and ids, answer ids and
partition counts exact; answer distances at rtol 1e-6 with atol 1e-6
(float32 sums ordered differently by XLA and torch); within the port,
concurrent == synchronous and buffer scan == post-flush search bit for
bit; against a float64 numpy brute force, distances at rtol 1e-5.
"""
from __future__ import annotations

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsm as RL
from repro.core import summarization as RS
from repro.core import windows as RW
from repro.core.metrics import IngestMetrics as RIngestMetrics
from repro.core.metrics import fill_factor as r_fill_factor
from repro.data import series as RSeries
from repro_torch.configs import SMOKE_INDEX as CFG
from repro_torch.configs import SMOKE_LEAF as LEAF
from repro_torch.core import lsm as PL
from repro_torch.core.lsm import CoconutLSM
from repro_torch.core.metrics import IngestMetrics, IOStats, fill_factor
from repro_torch.core.windows import WINDOW_MODES, window_engine
from repro_torch.data import series as PSeries
from repro_torch.ingest import FrozenBuffer, Snapshot
from repro_torch.obs import get_registry
from repro_torch.storage import SegmentStore

N = 3000
NQ = 6
L = CFG.series_len
RCFG = RS.SummaryConfig(CFG.series_len, CFG.segments, CFG.bits)
TOL = dict(rtol=1e-6, atol=1e-6)
MODES = ["pp", "tp", "btp"]
COLUMNS = ("keys", "codes", "paas", "offsets", "raw", "raw_ref",
           "timestamps", "ids")


def _walks(rng, n, length):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    raw = _walks(rng, N, L)
    q = _walks(rng, NQ, L)
    q[::2] = raw[rng.integers(0, N, (NQ + 1) // 2)] + 0.1 * \
        rng.standard_normal(((NQ + 1) // 2, L)).astype(np.float32)
    return raw, q


def _batches(raw, size):
    for s in range(0, len(raw), size):
        yield raw[s: s + size]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _port(**kw):
    kw.setdefault("leaf_size", LEAF)
    return CoconutLSM(CFG, device="cpu", **kw)


def _ref(**kw):
    kw.setdefault("leaf_size", LEAF)
    return RL.CoconutLSM(RCFG, **kw)


def _structure(eng):
    return ([(r.n, r.level, r.t_min, r.t_max) for r in eng.runs],
            eng.merges, eng._buf_count, eng.clock, eng.level_histogram())


def _same_runs(port, ref):
    assert _structure(port) == _structure(ref)
    for pr, rr in zip(port.runs, ref.runs):
        np.testing.assert_array_equal(pr.tree.keys.numpy(),
                                      np.asarray(rr.tree.keys).astype(
                                          np.int64))
        np.testing.assert_array_equal(pr.tree.ids.numpy(),
                                      np.asarray(rr.tree.ids))
        np.testing.assert_array_equal(pr.tree.timestamps.numpy(),
                                      np.asarray(rr.tree.timestamps))
        assert pr.key_fence == rr.key_fence


def _same_answers(p, r):
    (pd, po, pi), (rd, ro, ri) = p, r
    np.testing.assert_array_equal(po, ro)
    np.testing.assert_allclose(pd, rd, **TOL)
    for key in ("partitions_touched", "partitions_pruned", "buffer_rows",
                "leaves_scanned", "leaves_pruned"):
        assert pi[key] == ri[key], key


def _brute(q, rows, k):
    d = ((rows[None].astype(np.float64) - q[:, None]) ** 2).sum(-1)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, 1), idx


# ------------------------------------------------------ structure vs reference

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("batch", [300, 700])
def test_run_structure_matches_reference(data, mode, batch):
    """Run sizes, levels, time ranges, merge counts, keys and ids equal
    the reference's after every insert batch and after the final flush."""
    raw, _ = data
    port, ref = _port(buffer_capacity=512, mode=mode), \
        _ref(buffer_capacity=512, mode=mode)
    for b in _batches(raw, batch):
        port.insert(b)
        ref.insert(b)
        assert _structure(port) == _structure(ref)
    port.flush()
    ref.flush()
    _same_runs(port, ref)
    port.check_invariants()
    assert port.n == ref.n == N
    assert port.max_id() == ref.max_id() == N - 1
    assert port.rows_inserted == N


@pytest.mark.concurrency
@pytest.mark.timeout(240)
@pytest.mark.parametrize("mode", MODES)
def test_concurrent_structure_and_answers_match_reference(data, mode):
    """A concurrent engine held to no debt (``max_debt=0``: every insert
    waits until its flushes and merges have retired) has the reference's
    synchronous run structure after every batch, and its snapshots give
    the reference's answers."""
    raw, q = data
    ref = _ref(buffer_capacity=512, mode=mode)
    with _port(buffer_capacity=512, mode=mode, concurrent=True,
               max_debt=0) as port:
        for i, b in enumerate(_batches(raw, 250)):
            port.insert(b)
            ref.insert(b)
            assert _structure(port)[:2] == _structure(ref)[:2]
            if i % 4 == 3:
                _same_answers(
                    port.search_exact_batch(q, k=3, window=900),
                    ref.snapshot(include_buffer=True).search_exact_batch(
                        q, k=3, window=900))
        port.flush()
        ref.flush()
        _same_runs(port, ref)
        _same_answers(port.search_exact_batch(q, k=5),
                      ref.search_exact_batch(q, k=5))
        assert port.compaction_debt() == 0 and port.ingest_lag() == 0


# ------------------------------------------------------------ window answers

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("window", [None, 700, 1100])
@pytest.mark.parametrize("k", [1, 5])
def test_windowed_exact_matches_reference_and_brute_force(data, mode,
                                                          window, k):
    raw, q = data
    port, ref = _port(buffer_capacity=512, mode=mode), \
        _ref(buffer_capacity=512, mode=mode)
    for b in _batches(raw, 500):
        port.insert(b)
        ref.insert(b)
    port.flush()
    ref.flush()
    p = port.search_exact_batch(q, k=k, window=window)
    _same_answers(p, ref.search_exact_batch(q, k=k, window=window))
    lo = 0 if window is None else N - window
    bd, bi = _brute(q, raw[lo:], k)
    np.testing.assert_allclose(p[0], bd, rtol=1e-5)
    np.testing.assert_array_equal(p[1], bi + lo)
    # the single-query path is the batch's row
    d1, o1, _ = port.search_exact(q[1], k=k, window=window)
    np.testing.assert_array_equal(_bits(d1), _bits(p[0][1]))
    np.testing.assert_array_equal(o1, p[1][1])


def test_btp_touches_fewer_partitions_than_tp(data):
    raw, q = data
    touched = {}
    for mode in ("tp", "btp"):
        lsm = _port(buffer_capacity=256, mode=mode)
        ref = _ref(buffer_capacity=256, mode=mode)
        for b in _batches(raw, 300):
            lsm.insert(b)
            ref.insert(b)
        lsm.flush()
        ref.flush()
        _, _, st = lsm.search_exact(q[0], window=500)
        _, _, rst = ref.search_exact(q[0], window=500)
        touched[mode] = st["partitions_touched"] + st["partitions_pruned"]
        assert touched[mode] == (rst["partitions_touched"]
                                 + rst["partitions_pruned"])
    assert touched["btp"] < touched["tp"]


# ------------------------------------------------------- buffer partitions

@pytest.mark.concurrency
@pytest.mark.timeout(180)
def test_buffer_partition_matches_flushed_engine(data):
    """A frozen-buffer partition returns the same distance bits as the
    same rows after a flush (the concurrent-visibility invariant, owned
    by the executor's buffer scan through the cross form)."""
    raw, q = data
    with _port(buffer_capacity=256, concurrent=True, max_debt=64) as conc:
        conc.insert(raw[:1000])
        d_buf, off_buf, _ = conc.search_exact_batch(q, k=3)
        conc.flush()
        d_run, off_run, _ = conc.search_exact_batch(q, k=3)
    np.testing.assert_array_equal(_bits(d_buf), _bits(d_run))
    np.testing.assert_array_equal(off_buf, off_run)


@pytest.mark.parametrize("k", [1, 4, 40])
def test_buffer_scan_matches_reference_and_flush(data, k):
    """Rows still in a synchronous engine's buffer, seen through
    ``snapshot(include_buffer=True)``: the reference's answers, and the
    bits of the same rows after a flush.  k above the buffer's size pads
    with (inf, -1) as the reference does."""
    raw, q = data
    port, ref = _port(buffer_capacity=4096), _ref(buffer_capacity=4096)
    port.insert(raw[:1500])
    ref.insert(raw[:1500])
    port.flush()
    ref.flush()
    port.insert(raw[1500:1530])
    ref.insert(raw[1500:1530])
    p = port.snapshot(include_buffer=True).search_exact_batch(
        q, k=k, window=30)
    r = ref.snapshot(include_buffer=True).search_exact_batch(
        q, k=k, window=30)
    _same_answers(p, r)
    assert p[2]["buffer_rows"] == 30
    if k == 40:
        assert np.all(p[1][:, 30:] == -1) and np.all(np.isinf(p[0][:, 30:]))
    full = port.snapshot(include_buffer=True).search_exact_batch(q, k=k)
    port.flush()
    after = port.search_exact_batch(q, k=k)
    np.testing.assert_array_equal(_bits(full[0]), _bits(after[0]))
    np.testing.assert_array_equal(full[1], after[1])


def test_frozen_buffer_and_snapshot_views(data):
    raw, q = data
    buf = FrozenBuffer(raw=raw[:10], ts=np.arange(10, dtype=np.int64),
                       ids=np.arange(100, 110, dtype=np.int64))
    snap = Snapshot(runs=(), clock=10, mode="btp", buffer=buf, cfg=CFG,
                    device=torch.device("cpu"))
    assert snap.n == 10
    d, o, info = snap.search_exact_batch(q, k=2)
    bd, bi = _brute(q, raw[:10], 2)
    np.testing.assert_array_equal(o, bi + 100)
    np.testing.assert_allclose(d, bd, rtol=1e-5)
    assert info["buffer_rows"] == 10 and info["candidates"] == 10


# --------------------------------------------------- carrying state across

def _ref_state(r):
    """A reference engine's state in the shape ``lsm.from_numpy`` takes."""
    runs = [{"level": run.level, "t_min": run.t_min, "t_max": run.t_max,
             "columns": {name: np.asarray(getattr(run.tree, name))
                         for name in COLUMNS
                         if getattr(run.tree, name) is not None}}
            for run in r.runs]
    buffer = [{"raw": raw, "ts": ts, "ids": ids}
              for raw, ts, ids in zip(r._buf_raw, r._buf_ts, r._buf_ids)]
    return {"cfg": {"series_len": r.cfg.series_len,
                    "segments": r.cfg.segments, "bits": r.cfg.bits},
            "buffer_capacity": r.buffer_capacity, "leaf_size": r.leaf_size,
            "size_ratio": r.size_ratio, "mode": r.mode,
            "materialized": r.materialized, "clock": r.clock,
            "merges": r.merges, "rows_inserted": r._rows_inserted,
            "runs": runs, "buffer": buffer}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("materialized", [True, False])
def test_lsm_carried_across_from_reference(data, mode, materialized):
    """``lsm.from_numpy`` turns a reference engine's state into a port
    engine that answers as the reference does, then ingests the same
    batches into the same run structure; ``lsm.to_numpy`` inverts it."""
    raw, q = data
    ref = _ref(buffer_capacity=512, mode=mode, materialized=materialized)
    for b in _batches(raw[:1900], 350):
        ref.insert(b)
    state = _ref_state(ref)
    port = PL.from_numpy(state, device="cpu")
    assert _structure(port) == _structure(ref)
    back = PL.to_numpy(port)
    assert back["clock"] == state["clock"]
    for pr, rr in zip(back["runs"], state["runs"]):
        assert (pr["level"], pr["t_min"], pr["t_max"]) == \
            (rr["level"], rr["t_min"], rr["t_max"])
        for name, v in rr["columns"].items():
            np.testing.assert_array_equal(pr["columns"][name], v)
    for pb, rb in zip(back["buffer"], state["buffer"]):
        np.testing.assert_array_equal(pb["raw"], rb["raw"])
        np.testing.assert_array_equal(pb["ids"], rb["ids"])
    for window in (None, 600):
        _same_answers(port.search_exact_batch(q, k=3, window=window),
                      ref.search_exact_batch(q, k=3, window=window))
        _same_answers(
            port.snapshot(include_buffer=True).search_exact_batch(
                q, k=3, window=window),
            ref.snapshot(include_buffer=True).search_exact_batch(
                q, k=3, window=window))
    for b in _batches(raw[1900:], 350):
        port.insert(b)
        ref.insert(b)
        assert _structure(port) == _structure(ref)
    port.flush()
    ref.flush()
    _same_runs(port, ref)
    _same_answers(port.search_exact_batch(q, k=5, window=1000),
                  ref.search_exact_batch(q, k=5, window=1000))


def test_summaries_path_keys_with_zorder(data):
    """Batches inserted with their summaries flush through ``zorder``
    (no second summarize) and give the same runs and answers."""
    raw, q = data
    from repro_torch.kernels import ops
    with_sum, plain = _port(buffer_capacity=512, mode="tp"), \
        _port(buffer_capacity=512, mode="tp")
    for b in _batches(raw[:1600], 400):
        paa, codes = ops.sax_summarize(torch.from_numpy(b), CFG)
        with_sum.insert(b, summaries=(paa, codes))
        plain.insert(b)
    with_sum.flush()
    plain.flush()
    assert _structure(with_sum) == _structure(plain)
    for a, b in zip(with_sum.runs, plain.runs):
        assert torch.equal(a.tree.keys, b.tree.keys)
        assert torch.equal(a.tree.paas, b.tree.paas)
    d1, o1, _ = with_sum.search_exact_batch(q, k=3)
    d2, o2, _ = plain.search_exact_batch(q, k=3)
    np.testing.assert_array_equal(_bits(d1), _bits(d2))
    np.testing.assert_array_equal(o1, o2)


# --------------------------------------------------------------- metrics

def test_ingest_metrics_match_reference():
    port, ref = IngestMetrics(), RIngestMetrics()
    for m in (port, ref):
        m.add("bg_flushes")
        m.add("bg_flushes", 2)
        m.add("rows_ingested", 7)
        m.set_gauge("ingest_lag_rows", 5)
        m.set_gauge("compaction_debt", 1.5)
    assert port.snapshot() == ref.snapshot()
    assert port.get("bg_flushes") == 3 and port.get("nothing") == 0
    reg = get_registry()
    before = reg.counter("ingest.rows_ingested").value
    port.add("rows_ingested", 4)
    assert reg.counter("ingest.rows_ingested").value == before + 4
    assert fill_factor([10, 20, 30], 40) == r_fill_factor([10, 20, 30], 40)
    assert fill_factor([], 40) == 0.0


@pytest.mark.concurrency
@pytest.mark.timeout(120)
def test_engine_ingest_counters(data):
    raw, _ = data
    with _port(buffer_capacity=128, mode="btp", concurrent=True) as lsm:
        for b in _batches(raw[:1000], 100):
            lsm.insert(b)
        lsm.flush()
        snap = lsm.ingest.snapshot()
        assert snap["rows_ingested"] == 1000
        assert snap["bg_flushes"] >= 1000 // 128
        assert snap["bg_merges"] == lsm.merges > 0
        assert snap["ingest_lag_rows"] == 0 and snap["compaction_debt"] == 0
    hist = get_registry().histogram("compact.flush_ms")
    assert hist.count > 0


# --------------------------------------------------------- window engines

@pytest.mark.parametrize("mode", WINDOW_MODES)
def test_window_engine_matches_reference(data, mode):
    raw, q = data
    eng = window_engine(mode, CFG, buffer_capacity=512, leaf_size=LEAF,
                        device="cpu")
    ref = RW.window_engine(mode, RCFG, buffer_capacity=512, leaf_size=LEAF)
    assert isinstance(eng, CoconutLSM) and eng.mode == mode
    for b in _batches(raw, 600):
        eng.insert(b)
        ref.insert(b)
    eng.flush()
    ref.flush()
    _same_answers(eng.search_exact_batch(q, k=2, window=900),
                  ref.search_exact_batch(q, k=2, window=900))


def test_unported_options_raise(data, tmp_path):
    """No window-engine option is unported any more: the sharded engine
    comes with ``shards > 1`` (persisted through ``data_dir=``, never
    ``store=``), ``data_dir=`` is ignored at one shard as in the
    reference, and the durable options (store, tiers, WAL policy, open,
    checkpoint) work; what the reference refuses raises."""
    from repro_torch.distributed import ShardedCoconutLSM
    with pytest.raises(ValueError):
        window_engine("lsm", CFG, device="cpu")
    assert isinstance(window_engine("btp", CFG, shards=2, device="cpu"),
                      ShardedCoconutLSM)
    with pytest.raises(ValueError, match="data_dir"):
        window_engine("btp", CFG, shards=2, device="cpu",
                      store=SegmentStore(str(tmp_path / "s")))
    one = window_engine("btp", CFG, data_dir=str(tmp_path / "ignored"),
                        device="cpu")
    assert isinstance(one, CoconutLSM) and one.store is None
    assert not (tmp_path / "ignored").exists()
    with pytest.raises(ValueError, match="fsync"):
        CoconutLSM(CFG, device="cpu", wal_fsync="sometimes",
                   store=SegmentStore(str(tmp_path / "bad")))
    with pytest.raises(FileNotFoundError, match="no committed manifest"):
        CoconutLSM.open(str(tmp_path / "none"), device="cpu")
    # without a store, tiers and a WAL policy are ignored, as in the
    # reference, and a checkpoint is a flush
    eng = _port(tiers=object(), wal_fsync="never", buffer_capacity=512)
    assert eng.tiers is None and eng.wal is None
    eng.insert(data[0][:100])
    eng.checkpoint()
    assert eng.ingest_lag() == 0 and eng.n == 100
    with pytest.raises(ValueError):
        CoconutLSM(CFG, mode="lsm", device="cpu")


# ----------------------------------------------------------- data series

@pytest.mark.parametrize("step", [1, 4])
@pytest.mark.parametrize("znorm", [False, True])
def test_sliding_windows_match_reference(step, znorm):
    rng = np.random.default_rng(4)
    sig = np.cumsum(rng.standard_normal(2000)).astype(np.float32)
    got = PSeries.sliding_windows(torch.from_numpy(sig), 64, step,
                                  znorm=znorm).numpy()
    want = np.asarray(RSeries.sliding_windows(jnp.asarray(sig), 64, step,
                                              znorm=znorm))
    assert got.shape == want.shape == ((2000 - 64) // step + 1, 64)
    if znorm:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_synthetic_signal_and_series_batches():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    s1 = PSeries.synthetic_signal(g1, 5000)
    s2 = PSeries.synthetic_signal(g2, 5000)
    assert s1.shape == (5000,) and s1.dtype == torch.float32
    assert torch.equal(s1, s2) and torch.isfinite(s1).all()
    sizes = [b.shape for b in PSeries.series_batches(
        torch.Generator().manual_seed(0), 1000, 300, 32)]
    assert sizes == [(300, 32)] * 3 + [(100, 32)]
    b = next(PSeries.series_batches(torch.Generator().manual_seed(0),
                                    10, 10, 32))
    assert isinstance(b, np.ndarray) and b.dtype == np.float32
    np.testing.assert_allclose(b.mean(1), 0, atol=1e-5)


# ----------------------------------------- store-less ingest battery (port)

@pytest.mark.concurrency
@pytest.mark.timeout(240)
@pytest.mark.parametrize("mode", MODES)
def test_interleaved_insert_search_parity(mode, data):
    """At every interleaving point, exact answers from the concurrent
    engine (runs in whatever state the compactor reached + frozen buffer)
    are bit-identical to the synchronous engine over the same inserts."""
    raw, q = data
    raw = raw[:1100]
    sync = _port(buffer_capacity=128, leaf_size=32, mode=mode)
    with _port(buffer_capacity=128, leaf_size=32, mode=mode,
               concurrent=True, max_debt=2) as conc:
        for b in _batches(raw, 173):
            sync.insert(b)
            sync.flush()                 # sync searches only see runs
            conc.insert(b)               # compactor races the searches
            for qq in q[:2]:
                d_s, _, _ = sync.search_exact(qq)
                d_c, _, _ = conc.search_exact(qq)
                np.testing.assert_array_equal(_bits(d_s), _bits(d_c))
                d_sw, _, _ = sync.search_exact(qq, window=300)
                d_cw, _, _ = conc.search_exact(qq, window=300)
                np.testing.assert_array_equal(_bits(d_sw), _bits(d_cw))
            bd_s, bo_s, _ = sync.search_exact_batch(q, k=3)
            bd_c, bo_c, _ = conc.search_exact_batch(q, k=3)
            np.testing.assert_array_equal(_bits(bd_s), _bits(bd_c))
            np.testing.assert_array_equal(bo_s, bo_c)
            bd_sw, _, _ = sync.search_exact_batch(q, k=2, window=500)
            bd_cw, _, _ = conc.search_exact_batch(q, k=2, window=500)
            np.testing.assert_array_equal(_bits(bd_sw), _bits(bd_cw))
        conc.flush()
        conc.check_invariants()
        assert conc.n == sync.n == len(raw)


@pytest.mark.concurrency
@pytest.mark.timeout(180)
def test_search_during_sustained_ingest(data):
    """Queries keep answering correctly while an ingest thread inserts
    and the compactor flushes/merges underneath: every answer is exact
    for some batch boundary between the sizes seen before and after."""
    raw, q = data
    raw = raw[:1100]
    stop = threading.Event()
    with _port(buffer_capacity=128, leaf_size=32, mode="btp",
               concurrent=True, max_debt=3) as lsm:

        def ingest():
            for b in _batches(raw, 64):
                if stop.is_set():
                    return
                lsm.insert(b)

        t = threading.Thread(target=ingest)
        t.start()
        try:
            for _ in range(20):
                n_before = lsm.n
                dk, _, _ = lsm.search_exact(q[0])
                d = float(dk[0])
                n_after = lsm.n
                cands = {n_before, n_after} | {
                    m for m in range(n_before, n_after + 1) if m % 64 == 0}
                ok = any(abs(d - _brute(q[:1], raw[:m], 1)[0][0, 0]) < 1e-4
                         for m in sorted(cands) if m > 0)
                assert ok or not np.isfinite(d)
                time.sleep(0.01)
        finally:
            stop.set()
            t.join()
        lsm.flush()
        d, _, _ = lsm.search_exact(q[0])
        assert abs(float(d[0]) - _brute(q[:1], raw, 1)[0][0, 0]) < 1e-4


@pytest.mark.concurrency
@pytest.mark.timeout(120)
def test_backpressure_bounds_debt(data):
    raw, _ = data
    raw = raw[:1100]
    with _port(buffer_capacity=64, leaf_size=32, mode="btp",
               concurrent=True, max_debt=1) as lsm:
        seen = 0
        for b in _batches(raw, 50):
            lsm.insert(b)
            seen = max(seen, lsm.compaction_debt())
        assert seen <= lsm.max_debt + 1
        lsm.flush()
        assert lsm.n == len(raw)
        assert lsm.ingest.get("bg_flushes") > 0


@pytest.mark.concurrency
@pytest.mark.timeout(120)
def test_compactor_error_propagates(data):
    raw, _ = data
    lsm = _port(buffer_capacity=64, leaf_size=32, concurrent=True)
    try:
        boom = RuntimeError("injected compaction failure")

        def bad_step(force=False):
            raise boom

        lsm._bg_step = bad_step
        with pytest.raises(RuntimeError):
            for b in _batches(raw[:1100], 64):
                lsm.insert(b)
                time.sleep(0.01)
        assert lsm._compactor.error is boom
    finally:
        lsm._closed = True              # skip drain: worker is poisoned
        lsm._compactor._stop = True
        lsm._compactor.notify()


@pytest.mark.concurrency
@pytest.mark.timeout(120)
def test_close_is_deterministic_and_idempotent(data):
    raw, _ = data
    lsm = _port(buffer_capacity=128, leaf_size=32, concurrent=True)
    lsm.insert(raw[:400])
    worker = lsm._compactor._thread
    assert worker.is_alive()
    lsm.close()
    assert not worker.is_alive()        # thread joined, not abandoned
    lsm.close()                         # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        lsm.insert(raw[:10])
    with pytest.raises(RuntimeError, match="closed"):
        lsm.flush()


def test_sync_engine_snapshot_excludes_buffer(data):
    """Unflushed rows stay invisible to a synchronous engine's searches
    until flush()."""
    raw, q = data
    lsm = _port(buffer_capacity=4096, leaf_size=32)
    lsm.insert(raw[:500])
    d, off, _ = lsm.search_exact(q[0])
    assert not np.isfinite(d[0]) and off[0] == -1
    lsm.flush()
    d, off, _ = lsm.search_exact(q[0])
    assert abs(float(d[0]) - _brute(q[:1], raw[:500], 1)[0][0, 0]) < 1e-4


@pytest.mark.concurrency
@pytest.mark.timeout(60)
def test_iostats_thread_safe():
    io = IOStats(64)
    per_thread = 20_000

    def work():
        for _ in range(per_thread):
            io.rand_read(1)
            io.read_bytes(3)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert io.counters["rand_read_blocks"] == 8 * per_thread
    assert io.bytes_read == 8 * per_thread * 3
    merged = io.merged(IOStats(64))
    assert merged.counters["rand_read_blocks"] == 8 * per_thread
