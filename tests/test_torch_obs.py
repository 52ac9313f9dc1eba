"""Port parity: the rest of ``obs`` — profiled kernel launches, workload
analytics, health, the HTTP scrape and validation — PyTorch vs the JAX
reference.

The analytics, health, HTTP and validation modules are host code that
the port copies; they are held to the reference's outputs on the same
inputs: the same validation error lists, the same
``WorkloadAnalyzer.profile()`` over one query log (written here by the
port's 4-shard engine on the CPU), byte-identical Prometheus text for
one ``describe_metrics`` document, and the same health states and
events.  ``profiled`` is the port's own (``torch.profiler`` in place of
``jax.profiler``): it is held to the reference's semantics — a
passthrough when off; one ``kernel.<name>_ms`` observation and one span
per dispatcher call when on.
"""
from __future__ import annotations

import json
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.obs import analytics as RA
from repro.obs import health as RH
from repro.obs import httpd as RHT
from repro.obs import validate as RV
from repro.obs.registry import MetricsRegistry as RRegistry
from repro_torch.configs import SMOKE_INDEX as CFG
from repro_torch.distributed import ShardedCoconutLSM
from repro_torch.kernels import ops
from repro_torch.obs import (QueryLog, add_probe_observer, describe_metrics,
                             disable_tracing, enable_tracing, get_registry,
                             get_tracer, install_query_log,
                             remove_probe_observer)
from repro_torch.obs import analytics as PA
from repro_torch.obs import health as PH
from repro_torch.obs import httpd as PHT
from repro_torch.obs import profile as PP
from repro_torch.obs import validate as PV
from repro_torch.obs.registry import MetricsRegistry

PROFILED = ("mindist_batch", "mindist_batch_packed", "scan_verify",
            "mesh_scan")


@pytest.fixture
def obs():
    """Clean port observability state around each test (the registry,
    tracer, query log and profiling mode are process-global)."""
    get_registry().reset()
    disable_tracing()
    get_tracer().clear()
    prev = install_query_log(None)
    PP.disable_profiling()
    yield get_registry()
    PP.disable_profiling()
    get_registry().reset()
    disable_tracing()
    get_tracer().clear()
    install_query_log(prev)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, CFG.series_len)).astype(np.float32)


def _engine():
    return ShardedCoconutLSM(CFG, shards=4, buffer_capacity=256,
                             leaf_size=64, mode="btp", device="cpu")


def _session(log_dir, probes=5):
    """A 4-shard session on the CPU with its query log under ``log_dir``:
    2,048 rows, then ``probes`` batches of two queries at k = 3.  Returns
    the summed stats fields."""
    log = QueryLog(str(log_dir))
    install_query_log(log)
    rng = np.random.default_rng(7)
    sums = {"leaves_scanned": 0, "scan_bytes": 0, "buffer_rows": 0}
    eng = _engine()
    try:
        eng.insert(_data(2048))
        eng.flush()
        for _ in range(probes):
            q = rng.standard_normal((2, CFG.series_len)).astype(np.float32)
            _, _, info = eng.search_exact_batch(q, k=3)
            for f in sums:
                sums[f] += int(getattr(info["stats"], f))
    finally:
        eng.close()
        log.close()
        install_query_log(None)
    return sums


# ---------------------------------------------------------------- profiling

def _cpu_launches():
    """One call of each profiled dispatcher on the CPU twins."""
    q = torch.zeros((2, CFG.series_len))
    qp = torch.zeros((2, CFG.segments))
    codes = torch.zeros((5, CFG.segments), dtype=torch.uint8)
    raw = torch.zeros((5, CFG.series_len))
    packed = torch.zeros((5, CFG.segments * CFG.bits // 8), dtype=torch.uint8)
    ops.mindist_batch(qp, codes, CFG)
    ops.mindist_batch_packed(qp, packed, CFG)
    ops.scan_verify(q, qp, codes, raw, torch.full((2,), math.inf), CFG, k=1)
    ids = torch.arange(5, dtype=torch.int32)[None]
    ops.mesh_scan(q, qp, [codes[None]], [raw[None]], [ids],
                  [torch.zeros_like(ids)], None, torch.full((2,), math.inf),
                  CFG, k=1)


def test_profiled_off_is_a_passthrough(obs):
    assert PP.profiling_mode() == ""
    enable_tracing()
    _cpu_launches()
    assert not any(n.startswith("kernel.") for n in obs.snapshot())
    assert get_tracer().spans() == []
    with PP.profiled("x") as done:
        assert done(7) == 7
    assert "kernel.x_ms" not in obs.snapshot()


@pytest.mark.parametrize("mode", ["wall", "torch"])
def test_profiled_records_each_dispatcher_call(obs, mode):
    PP.enable_profiling(mode)
    enable_tracing()
    _cpu_launches()
    _cpu_launches()
    desc = obs.describe()
    for name in PROFILED:
        assert desc["histograms"][f"kernel.{name}_ms"]["count"] == 2, name
    spans = [s["name"] for s in get_tracer().spans()]
    assert sorted(spans) == sorted(f"kernel.{n}" for n in PROFILED * 2)
    assert all("wall_ms" in s["args"] for s in get_tracer().spans())


def test_profiled_torch_mode_names_the_range(obs):
    PP.enable_profiling("torch")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _cpu_launches()
    names = {e.key for e in prof.key_averages()}
    assert {f"coconut.{n}" for n in PROFILED} <= names


def test_profiling_env_and_errors(obs, monkeypatch):
    for v, want in (("1", "wall"), ("true", "wall"), ("WALL", "wall"),
                    ("torch", "torch"), ("", ""), ("jax", ""), ("0", "")):
        monkeypatch.setenv("COCONUT_PROFILE", v)
        assert PP._env_mode() == want, v
    with pytest.raises(ValueError, match="profiling mode"):
        PP.enable_profiling("jax")
    PP.enable_profiling()
    assert PP.profiling_mode() == "wall"
    PP.disable_profiling()
    assert PP.profiling_mode() == ""


def test_capture_writes_a_trace(obs, tmp_path, monkeypatch):
    monkeypatch.delenv("COCONUT_PROFILE_DIR", raising=False)
    with PP.capture(str(tmp_path / "a")):
        _cpu_launches()
    [trace] = list((tmp_path / "a").glob("capture-*.json"))
    assert json.loads(trace.read_text())["traceEvents"]
    monkeypatch.setenv("COCONUT_PROFILE_DIR", str(tmp_path / "b"))
    with PP.capture():
        pass
    assert list((tmp_path / "b").glob("capture-*.json"))
    monkeypatch.delenv("COCONUT_PROFILE_DIR")
    with PP.capture():                       # wall clock only
        pass
    assert obs.describe()["histograms"]["profile.capture_ms"]["count"] == 3


# ---------------------------------------------------------------- validate

def _trace_docs():
    good = {"traceEvents": [
        {"name": "probe", "ph": "X", "pid": 1, "tid": 1, "ts": 0,
         "dur": 100, "args": {"span_id": 1}},
        {"name": "plan", "ph": "X", "pid": 1, "tid": 1, "ts": 10,
         "dur": 20, "args": {"span_id": 2, "parent_id": 1}}]}
    docs = [{}, {"traceEvents": 3}, good]
    for mutate in (lambda d: d["traceEvents"][1].__setitem__("ts", 95),
                   lambda d: d["traceEvents"][0].pop("dur"),
                   lambda d: d["traceEvents"][1]["args"].__setitem__(
                       "parent_id", 99),
                   lambda d: d["traceEvents"][0]["args"].__setitem__(
                       "leaves_scanned", 5),
                   lambda d: d["traceEvents"][1].pop("pid"),
                   lambda d: d["traceEvents"].pop(1)):
        doc = json.loads(json.dumps(good))
        mutate(doc)
        docs.append(doc)
    return docs


def test_validate_equals_reference(obs, tmp_path):
    errs = [PV.validate(doc) for doc in _trace_docs()]
    assert errs == [RV.validate(doc) for doc in _trace_docs()]
    assert errs[2] == [] and all(errs[:2]) and all(errs[3:])
    # on the tracer's export and on a query log the port wrote
    enable_tracing()
    _session(tmp_path / "qlog", probes=2)
    exported = get_tracer().export_chrome()
    assert PV.validate(exported) == RV.validate(exported) == []
    assert PV.validate_query_log(str(tmp_path / "qlog")) == \
        RV.validate_query_log(str(tmp_path / "qlog")) == []
    # a hole and a record without seq
    live = tmp_path / "qlog" / "query_log.jsonl"
    lines = live.read_text().splitlines()
    live.write_text("\n".join(lines[:1] + ['{"kind": "t"}']) + "\n")
    got = PV.validate_query_log(str(tmp_path / "qlog"))
    assert got and got == RV.validate_query_log(str(tmp_path / "qlog"))


# ---------------------------------------------------------------- analytics

@pytest.mark.timeout(300)
def test_workload_analyzer_equals_reference(obs, tmp_path):
    """On the log of a real 4-shard session: the reference's profile, the
    logged stats summed bit for bit, and a certified registry check."""
    sums = _session(tmp_path)
    assert sums["leaves_scanned"] > 0
    ana = PA.WorkloadAnalyzer().feed_all(PA.iter_query_log(str(tmp_path)))
    prof = ana.profile()
    ref = RA.WorkloadAnalyzer().feed_all(RA.iter_query_log(str(tmp_path)))
    assert prof == ref.profile()
    assert prof["complete"] and prof["records"] == 5
    assert prof["queries"] == 10 and prof["kinds"] == {"sharded.exact": 5}
    for f, total in sums.items():
        assert prof["totals"][f] == total
    assert ana.check_against(describe_metrics()) == []
    shards = {info["shard"] for info in prof["leaf_heat"].values()}
    assert shards <= {"s0", "s1", "s2", "s3"} and len(shards) > 1
    # a replay is deduplicated; a lossy log refuses to certify
    ana.feed_all(PA.iter_query_log(str(tmp_path)))
    assert ana.profile()["seq"]["duplicates"] == 5
    lossy = PA.WorkloadAnalyzer().feed_all(
        r for r in PA.iter_query_log(str(tmp_path)) if r["seq"] != 2)
    errs = lossy.check_against(describe_metrics())
    assert errs and "incomplete" in errs[0]


def test_analytics_cli_and_gini(obs, tmp_path, capsys):
    _session(tmp_path, probes=1)
    mpath = tmp_path / "metrics.json"
    mpath.write_text(json.dumps(describe_metrics()))
    assert PA.main([str(tmp_path), "--check-metrics", str(mpath)]) == 0
    out = json.loads((tmp_path / "WORKLOAD.json").read_text())
    assert out["records"] == 1 and out["complete"]
    assert "check-metrics: OK" in capsys.readouterr().out
    ref_out = tmp_path / "REF.json"
    assert RA.main([str(tmp_path), "--out", str(ref_out)]) == 0
    ref = json.loads(ref_out.read_text())
    assert out == ref
    bad = json.loads(mpath.read_text())
    bad["query.leaves_scanned_total"] += 1
    mpath.write_text(json.dumps(bad))
    assert PA.main([str(tmp_path), "--check-metrics", str(mpath)]) == 1
    assert PA.main([str(tmp_path / "nope")]) == 2
    for vals in ([], [5, 5, 5, 5], [10, 0, 0, 0], [1, 2, 3, 4], [0.5, 7]):
        assert PA.gini(vals) == RA.gini(vals)
    assert PA.gini([10, 0, 0, 0]) == pytest.approx(0.75)


# ------------------------------------------------------------------- health

def _events(path):
    return [{k: v for k, v in json.loads(line).items() if k != "t"}
            for line in path.read_text().splitlines()]


def test_health_transitions_equal_reference(tmp_path):
    debt = {"v": 0.0}
    mons = [M.HealthMonitor(sources={"compaction_debt": lambda: debt["v"]},
                            events_dir=str(tmp_path / tag), window_s=30.0,
                            registry=R())
            for M, R, tag in ((PH, MetricsRegistry, "port"),
                              (RH, RRegistry, "ref"))]
    states = []
    for v in (0.0, 20.0, 100.0, 0.0):
        debt["v"] = v
        docs = [m.evaluate() for m in mons]
        for doc in docs:
            doc.pop("t")
        assert docs[0] == docs[1]
        states.append(docs[0]["state"])
    assert states == ["ok", "degraded", "critical", "ok"]
    port = _events(tmp_path / "port" / "health_events.jsonl")
    assert port == _events(tmp_path / "ref" / "health_events.jsonl")
    assert [(e["from"], e["to"]) for e in port] == \
        [("ok", "degraded"), ("degraded", "critical"), ("critical", "ok")]
    assert "compaction_debt" in port[0]["failing"]
    assert mons[0].transitions == 3
    th = PH.Threshold(8.0, 64.0)
    assert th.state(8.0) == "ok" and th.state(8.1) == "degraded"
    assert th.state(64.1) == "critical"
    assert th.state(None) == "ok" and th.state(math.nan) == "ok"
    assert {n: (t.degraded, t.critical)
            for n, t in PH.DEFAULT_THRESHOLDS.items()} == \
        {n: (t.degraded, t.critical) for n, t in RH.DEFAULT_THRESHOLDS.items()}


def test_health_windowed_p99_equals_reference():
    """The window forgets: an old spike outside it does not keep p99 up,
    in both packages alike."""
    regs = (MetricsRegistry(), RRegistry())
    mons = [PH.HealthMonitor(window_s=3600.0, registry=regs[0]),
            RH.HealthMonitor(window_s=3600.0, registry=regs[1])]
    for batch in ((10000.0,) * 5, (2.0,) * 200):
        for reg, mon in zip(regs, mons):
            h = reg.histogram("query.probe_latency_ms")
            for v in batch:
                h.observe(v)
            mon.sample()
    v99 = [m.values()["probe_p99_ms"] for m in mons]
    assert v99[0] == v99[1] and v99[0] < 10.0
    assert regs[0].histogram("query.probe_latency_ms").percentile(99) > 1000


# --------------------------------------------------------------- prometheus

def test_render_prometheus_byte_identical(obs):
    for v in (0.0007, 0.5, 1.0, 3.0, 3.1, 10.0, 100.0, 1e12):
        obs.histogram("rt.latency_ms").observe(v)
    obs.counter("rt.calls_total").inc(3)
    obs.gauge("rt.lag_rows").set(11)
    obs.gauge("rt.nan_level").set(math.nan)
    _cpu_launches()
    for buckets in (True, False):
        desc = describe_metrics(buckets=buckets)
        assert PHT.render_prometheus(desc) == RHT.render_prometheus(desc)
    for name in ("rt.calls_total", "kernel.scan_verify_ms", "a-b.c d"):
        assert PHT.prom_name(name) == RHT.prom_name(name)


# ------------------------------------------------------------- HTTP server

def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode(), dict(r.headers)


@pytest.mark.concurrency
@pytest.mark.timeout(300)
def test_http_endpoints_live_sharded_engine(obs, tmp_path):
    """Scrape /metrics, /health and /workload while a 4-shard engine
    ingests and answers queries on other threads, with wall-mode
    profiling on; /health flips to 503 when a source goes critical."""
    log = QueryLog(str(tmp_path))
    install_query_log(log)
    ana = PA.WorkloadAnalyzer()
    add_probe_observer(ana.feed)
    debt = {"v": 0.0}
    mon = PH.HealthMonitor(sources={"compaction_debt": lambda: debt["v"]},
                           events_dir=str(tmp_path))
    raw = _data(2048)
    rng = np.random.default_rng(3)
    errs, scrapes = [], []
    PP.enable_profiling("wall")
    eng = _engine()
    try:
        with PHT.ObsHTTPServer(0, health=mon, analyzer=ana) as srv:
            stop = threading.Event()

            def writer():
                try:
                    for s in range(0, len(raw), 256):
                        eng.insert(raw[s: s + 256])
                    eng.flush()
                finally:
                    stop.set()

            def querier():
                try:
                    while not stop.is_set():
                        q = rng.standard_normal(
                            (2, CFG.series_len)).astype(np.float32)
                        eng.search_exact_batch(q, k=2)
                except Exception as e:     # pragma: no cover
                    errs.append(e)

            def scraper():
                try:
                    while not stop.is_set():
                        scrapes.append(_get(srv.url + "/metrics")[0])
                        scrapes.append(_get(srv.url + "/health")[0])
                except Exception as e:     # pragma: no cover
                    errs.append(e)

            threads = [threading.Thread(target=f)
                       for f in (writer, querier, scraper)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=240)
            assert not any(t.is_alive() for t in threads)
            assert not errs, errs
            assert scrapes and all(s == 200 for s in scrapes)
            eng.search_exact_batch(raw[:2], k=2)     # after the flush

            status, text, headers = _get(srv.url + "/metrics")
            assert status == 200
            assert "version=0.0.4" in headers["Content-Type"]
            desc = obs.describe(buckets=True)
            assert PHT.render_prometheus(desc) == \
                RHT.render_prometheus(desc)
            for n in (set(desc["counters"]) | set(desc["gauges"])
                      | set(desc["histograms"])):
                assert f"# TYPE {PHT.prom_name(n)} " in text, n
            assert f"{PHT.prom_name('kernel.mindist_batch_ms')}_bucket" \
                in text
            probes = desc["counters"]["query.probes_total"]
            assert f"{PHT.prom_name('query.probes_total')} {probes}" in text

            status, body, _ = _get(srv.url + "/health")
            assert status == 200
            assert set(json.loads(body)["checks"]) >= {"probe_p99_ms",
                                                       "compaction_debt"}
            status, body, _ = _get(srv.url + "/workload")
            prof = json.loads(body)
            assert prof["records"] == probes and prof["complete"]

            debt["v"] = 1e9
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(srv.url + "/health")
            assert ei.value.code == 503
            assert _get(srv.url + "/")[0] == 200
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(srv.url + "/nope")
            assert ei.value.code == 404
    finally:
        PP.disable_profiling()
        remove_probe_observer(ana.feed)
        eng.close()
        log.close()
    offline = PA.WorkloadAnalyzer().feed_all(PA.iter_query_log(str(tmp_path)))
    assert offline.profile()["totals"] == ana.profile()["totals"]
    assert ana.check_against(describe_metrics()) == []
