"""The query path's host stages and round trips, on the CPU twins.

Every host stage of a search is timed by ``repro_torch.obs.stage``: one
pair of clock readings gives its ``SearchStats.timings`` entry and, while
tracing is on, its span.  Held here for the four paths a search can take
(the eager exact chain, ``scan_mode="kernel"``, the budgeted drain, and
an LSM snapshot with its buffer under a window):

* the span tree is pinned, ``merge`` never lies under ``verify``, and
  the export passes ``obs.validate``;
* each stage's summed span durations equal its timing;
* ``SearchStats.host_syncs`` equals the count the loop's structure
  gives: two a seed probe (its window and its distances), one ``sync``
  a device-backed partition whose pools stayed on its device (however
  many leaf groups it issued), one a bound and one a verification of a
  host loop's group (four a fused group) and two a buffer scan, from the
  kernels' own call counts;
* tracing off records no span and gives the same answer bits.

The benchmark's readers of these numbers (``perfbench/metrics/``) are
read on the harness's tiny cells, and ``snapshot_ms`` on a synthetic
device trace.
"""
from __future__ import annotations

import collections
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.configs import SMOKE_INDEX as CFG
from repro_torch.configs import SMOKE_LEAF as LEAF
from repro_torch.core import tree as T
from repro_torch.core.lsm import CoconutLSM
from repro_torch.kernels import ops
from repro_torch.obs import (disable_tracing, enable_tracing, get_registry,
                             get_tracer, install_query_log, probe)
from repro_torch.obs import validate as PV
from repro_torch.query import Partition, exact_knn
from repro_torch.query import executor as X
from repro_torch.query.merger import DeviceKnnPool

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N = 3000
NQ = 4
K = 3
BUDGET = 3
WINDOW = 1400
PATHS = ("exact", "kernel", "budget", "lsm")
STAGES = ("plan", "seed", "seed.window", "seed.distances", "bound",
          "verify", "merge", "sync", "buffer", "frontier", "progress")

_SEED = [("scan", "seed"), ("seed", "seed.window"),
         ("seed", "seed.distances"), ("seed", "merge")]
_GROUP = [("scan", "prune"), ("scan", "bound"), ("scan", "verify"),
          ("scan", "merge")]
EDGES = {
    "exact": {("probe", "plan"), ("probe", "scan"), (None, "probe"),
              *_SEED, *_GROUP, ("scan", "sync")},
    "kernel": {("probe", "plan"), ("probe", "scan"), (None, "probe"),
               *_SEED, *_GROUP},
    "budget": {(None, "probe"), ("probe", "plan"), ("probe", "frontier"),
               ("probe", "progress"), ("probe", "scan"),
               *[("probe", c) for p, c in _SEED if p == "scan"],
               *[e for e in _SEED if e[0] == "seed"],
               *[e for e in _GROUP if e[1] != "prune"]},
    "lsm": {(None, "snapshot"), (None, "probe"), ("probe", "plan"),
            ("probe", "scan"), ("scan", "buffer"), ("buffer", "merge"),
            *_SEED, *_GROUP, ("scan", "sync")},
}


def _walks(rng, n, length):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


@pytest.fixture(autouse=True)
def obs():
    """The tracer, registry and query log are process-global."""
    get_registry().reset()
    disable_tracing()
    get_tracer().clear()
    prev = install_query_log(None)
    yield
    disable_tracing()
    get_tracer().clear()
    get_registry().reset()
    install_query_log(prev)


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(3)
    raw = _walks(rng, N, CFG.series_len)
    q = raw[rng.integers(0, N, NQ)] + 0.1 * rng.standard_normal(
        (NQ, CFG.series_len)).astype(np.float32)
    tree = T.build(raw, CFG, leaf_size=LEAF, device="cpu")
    eng = CoconutLSM(CFG, buffer_capacity=512, leaf_size=LEAF,
                     size_ratio=2, mode="btp", device="cpu")
    for s in range(0, 2300, 256):
        eng.insert(raw[s:min(s + 256, 2300)])
    yield SimpleNamespace(tree=tree, eng=eng, q=q.astype(np.float32))
    eng.close()


def _search(path, env):
    if path == "lsm":
        d, o, info = env.eng.snapshot(include_buffer=True) \
            .search_exact_batch(env.q, k=K, window=WINDOW)
        return d, o, info["stats"]
    with probe("tree." + path, queries=NQ, k=K) as rec:
        if path == "kernel":
            d, o, st = exact_knn([Partition.from_tree(env.tree)], env.q,
                                 CFG, k=K, scan_mode="kernel")
        else:
            d, o, st = T.exact_search_batch(
                env.tree, env.q, k=K,
                budget=BUDGET if path == "budget" else None)
        rec["stats"] = st
    return d, o, st


def _traced(path, env):
    enable_tracing()
    try:
        out = _search(path, env)
    finally:
        disable_tracing()
    return out, get_tracer().spans()


def _edges(spans):
    names = {s["id"]: s["name"] for s in spans}
    return {(names[s["parent"]] if s["parent"] else None, s["name"])
            for s in spans}


@pytest.mark.parametrize("path", PATHS)
def test_span_tree_is_pinned_and_valid(env, path):
    (_, _, st), spans = _traced(path, env)
    assert _edges(spans) == EDGES[path]
    assert get_tracer().dropped == 0
    assert not PV.validate(get_tracer().export_chrome())
    # a verification is the launch and its copy back, nothing under it
    ids = {s["parent"] for s in spans}
    assert not [s for s in spans if s["name"] == "verify" and s["id"] in ids]
    if path == "kernel":
        assert all(s["args"]["fused"] for s in spans
                   if s["name"] == "verify")
    # the scan spans' counts are deltas of the stats' counters (the
    # drain seeds outside its scan spans)
    scans = [s["args"] for s in spans if s["name"] == "scan"]
    if path != "budget":
        # the pools stay on the device on the eager chain's tree partitions
        sorted_scans = [a for a in scans if a.get("groups")]
        assert sorted_scans
        assert all(a["device_pool"] == (path != "kernel")
                   for a in sorted_scans)
        assert sum(a.get("candidates", 0) for a in scans) == st.candidates
        assert sum(a["host_syncs"] for a in scans) == st.host_syncs
    else:
        assert sum(a["host_syncs"] for a in scans) == st.host_syncs - 2


@pytest.mark.parametrize("path", PATHS)
def test_span_durations_are_the_timings(env, path):
    (_, _, st), spans = _traced(path, env)
    dur = collections.defaultdict(float)
    for s in spans:
        dur[s["name"]] += s["dur"]
    assert set(st.timings) == (set(dur) & set(STAGES)) | {"scan"}
    for name in set(dur) & set(STAGES):
        assert dur[name] / 1e3 == pytest.approx(st.timings[name],
                                                rel=1e-9, abs=1e-12), name
    verify = [s for s in spans if s["name"] == "verify"]
    assert sum(s["args"]["rows"] for s in verify) > 0


@pytest.mark.parametrize("path", PATHS)
def test_host_syncs_follow_the_loop(env, path, monkeypatch):
    calls = collections.Counter()

    def counted(name, fn, form=None):
        def wrap(*a, **kw):
            key = name if form is None else form(kw)
            calls[key] += 1
            return fn(*a, **kw)
        return wrap

    monkeypatch.setattr(ops, "mindist_batch",
                        counted("bound", ops.mindist_batch))
    monkeypatch.setattr(ops, "scan_verify",
                        counted("fused", ops.scan_verify))
    monkeypatch.setattr(ops, "batch_euclid_multi", counted(
        None, ops.batch_euclid_multi,
        lambda kw: "seed" if kw.get("idx") is not None else "cross"))
    monkeypatch.setattr(ops, "pool_merge", counted("fold", ops.pool_merge))
    monkeypatch.setattr(DeviceKnnPool, "store",
                        counted("sync", DeviceKnnPool.store))
    _, _, st = _search(path, env)
    buffers = 1 if path == "lsm" else 0
    assert calls["seed"] >= 1 and calls["cross"] + calls["fused"] > buffers
    if path in ("exact", "lsm"):
        # a fold a group, one copy back a partition
        assert calls["fold"] == calls["bound"] > 0 and calls["sync"] >= 1
        want = 2 * calls["seed"] + calls["sync"] + 2 * buffers
    else:
        assert calls["fold"] == calls["sync"] == 0
        want = (2 * calls["seed"] + calls["bound"] + calls["cross"]
                + 4 * calls["fused"])
    assert st.host_syncs == want, (calls, st.host_syncs)
    if path == "kernel":
        assert calls["bound"] == 0 and calls["fused"] > 0
    else:
        assert calls["fused"] == 0 and calls["bound"] > 0
    if path in ("exact", "lsm"):
        # a leaf a group: many more groups, the same round trips
        groups = calls["fold"]
        monkeypatch.setattr(X, "_leaves_per_group", lambda *a: 1)
        _, _, st1 = _search(path, env)
        assert calls["fold"] - groups > 2 * groups
        assert st1.host_syncs == st.host_syncs


@pytest.mark.parametrize("path", PATHS)
def test_tracing_off_records_nothing_and_same_bits(env, path):
    d0, o0, st0 = _search(path, env)
    assert get_tracer().spans() == []
    (d1, o1, st1), spans = _traced(path, env)
    assert spans
    np.testing.assert_array_equal(np.asarray(d0).view(np.uint32),
                                  np.asarray(d1).view(np.uint32))
    np.testing.assert_array_equal(o0, o1)
    assert st0.host_syncs == st1.host_syncs
    assert set(st0.timings) == set(st1.timings)


def test_merge_folds_host_syncs(env):
    """The sharded engine sums its shards' stats with ``merge``."""
    _, _, a = _search("exact", env)
    _, _, b = _search("lsm", env)
    want = a.host_syncs + b.host_syncs
    a.merge(b)
    assert a.host_syncs == want > 0


def test_stage_times_without_a_tracer():
    from repro_torch.obs import stage
    st = SimpleNamespace(timings={})
    with stage(st, "bound") as sp:
        sp.set(rows=1)
    with stage(st, "bound"):
        pass
    with stage(None, "snapshot"):
        pass
    assert set(st.timings) == {"bound"} and st.timings["bound"] >= 0
    assert get_tracer().spans() == []


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

NEW_METRICS = ("seed_ms", "bound_ms", "verify_ms", "merge_ms", "buffer_ms",
               "snapshot_ms", "host_syncs")


def _reader(name):
    from perfbench import run
    return run.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py",
                           f"test_stages_metric_{name}")


def _listed():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [(m["name"], w) for m in spec["per_layer"]
            if m["name"] in NEW_METRICS and m["name"] != "snapshot_ms"
            for w in m["workloads"]]


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    from perfbench import run
    from perfbench.tests.tiny import make_tiny_root
    root = make_tiny_root(tmp_path_factory.mktemp("bench") / "checkout")
    return {w: run.run_cell(w, 2**31 + 29, 0.3, True, root=root,
                            device="cpu", t_start=0.0)
            for w in ("tree-exact-q64", "lsm-window-q64", "tree-approx-b16")}


@pytest.mark.parametrize("metric,workload", _listed())
def test_stage_readers_read_the_tiny_cells(tiny_runs, metric, workload):
    r = tiny_runs[workload]
    assert r["correct"], r["checks"]
    assert r["metrics"][metric]["value"] > 0


def test_snapshot_ms_reads_the_trace():
    from perfbench.trace import DeviceTrace
    spans = [("request.knn", 0, 9_000_000, 0),
             ("snapshot", 1_000_000, 3_000_000, 1),
             ("probe", 3_000_000, 8_000_000, 1),
             ("request.knn", 9_000_000, 12_000_000, 0),
             ("snapshot", 9_500_000, 10_500_000, 1)]
    win = SimpleNamespace(records=[{}, {}], trace=DeviceTrace(
        [("k", 4_000_000, 5_000_000)], 0, 12_000_000, spans))
    read = _reader("snapshot_ms").read
    assert read(win) == pytest.approx(1.5)
    win.trace.spans = [s for s in spans if s[0] != "snapshot"]
    assert read(win) is None
    win.trace = None
    assert read(win) is None


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_stage_readers_read_nothing_from_an_older_program(metric):
    """A program without the stages or the counter: no value, no raise."""
    win = SimpleNamespace(trace=None, records=[
        {"stats": SimpleNamespace(timings={"plan": 1.0, "scan": 2.0})},
        {"stats": None}])
    assert _reader(metric).read(win) is None
