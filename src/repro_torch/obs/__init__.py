"""Observability: unified metrics registry, query tracing, profiling.

One substrate under the whole serving stack (the port's own copy; it
imports nothing from the reference package):

* :mod:`repro_torch.obs.registry` — named counters/gauges/histograms
  behind the ``subsystem.metric_unit`` naming convention; ``IOStats``
  mirrors into it, the query pipeline folds every ``SearchStats`` into
  it, and :func:`describe_metrics` is the one scrape point.
* :mod:`repro_torch.obs.trace` — per-query span trees (plan → seed →
  scan → prune / bound → verify → merge, plus per-shard fan-out),
  ring-buffered and exported as Chrome/Perfetto ``trace_event`` JSON;
  :func:`stage` times a host stage into ``SearchStats.timings`` and its
  span with one pair of clock readings.
* :mod:`repro_torch.obs.querylog` — one structured JSON record per
  probe, size-rotated alongside the WAL; the input for
  workload-adaptive maintenance.
* :mod:`repro_torch.obs.profile` — gated ``torch.profiler`` ranges
  around kernel launches with a wall-clock mode.
* :mod:`repro_torch.obs.analytics`, :mod:`~repro_torch.obs.health`,
  :mod:`~repro_torch.obs.httpd`, :mod:`~repro_torch.obs.validate` — the
  workload analyzer over the query log, the SLO monitor, the HTTP scrape
  (``/metrics``, ``/health``, ``/workload``) and the artifact validator.

:func:`probe` is the root scope every top-level search entry point
opens: it tracks nesting (the sharded engine's per-shard sub-searches
must not each emit a probe record), measures end-to-end latency, opens
the root trace span, and — for the *outermost* probe only — bumps the
``query.*`` registry totals and writes the query-log record.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Optional

from .querylog import QueryLog, get_query_log, install_query_log
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       describe_metrics, get_registry, sample_percentile)
from .trace import (Tracer, disable_tracing, enable_tracing, get_tracer,
                    span, stage)

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "get_registry", "describe_metrics", "sample_percentile",
           "Tracer", "get_tracer", "enable_tracing", "disable_tracing",
           "span", "stage",
           "QueryLog", "install_query_log", "get_query_log",
           "probe", "record_search", "budget_dict",
           "add_probe_observer", "remove_probe_observer"]

_probe_depth: contextvars.ContextVar[int] = \
    contextvars.ContextVar("coconut_probe_depth", default=0)

# Live subscribers to finished outermost-probe records (the same dict
# the query log persists).  The workload analyzer attaches here when
# serving /workload from a live process, so the HTTP endpoint never
# re-reads the log files it is itself producing.
_OBSERVERS: list = []


def add_probe_observer(fn) -> None:
    """Register ``fn(rec: dict)`` to be called with every finished
    outermost probe record (after stats/latency are folded in).
    Observers must be fast and never raise; they run on the probe's
    thread."""
    _OBSERVERS.append(fn)


def remove_probe_observer(fn) -> None:
    """Unregister a probe observer (no-op when absent)."""
    try:
        _OBSERVERS.remove(fn)
    except ValueError:
        pass


def budget_dict(budget) -> Optional[dict]:
    """A query budget (``max_leaves``/``max_bytes``/``deadline_ms``) as
    a JSON-ready dict (None-safe)."""
    if budget is None:
        return None
    return {"max_leaves": budget.max_leaves,
            "max_bytes": budget.max_bytes,
            "deadline_ms": budget.deadline_ms}


def _stats_attrs(stats) -> dict:
    """Span/log attributes from a ``SearchStats`` (duck-typed so this
    package never imports the query layer)."""
    attrs = {"candidates": int(stats.candidates),
             "leaves_scanned": int(stats.leaves_scanned),
             "leaves_pruned": int(stats.leaves_pruned),
             "scan_bytes": int(stats.scan_bytes),
             "buffer_rows": int(stats.buffer_rows),
             "partitions_touched": int(stats.partitions_touched),
             "partitions_pruned": int(stats.partitions_pruned),
             "exact": bool(stats.exact)}
    if stats.shards_touched or stats.shards_pruned:
        attrs["shards_touched"] = int(stats.shards_touched)
        attrs["shards_pruned"] = int(stats.shards_pruned)
    if stats.budget_exhausted:
        attrs["budget_exhausted"] = True
    if stats.gap is not None:
        g = stats.gap
        attrs["gap_max"] = float(g.max()) if len(g) else 0.0
        attrs["gap_mean"] = float(g.mean()) if len(g) else 0.0
    return attrs


def record_search(stats, prefix: str = "query") -> None:
    """Fold one pipeline invocation's ``SearchStats`` into the global
    registry — the SearchStats "view": totals aggregate across engines,
    shards, and threads under ``query.*``.  Called at the executor /
    drain choke points, so every entry point is covered exactly once
    per pipeline run."""
    reg = get_registry()
    reg.counter(f"{prefix}.pipeline_runs_total").inc()
    reg.counter(f"{prefix}.candidates_total").inc(int(stats.candidates))
    reg.counter(f"{prefix}.leaves_scanned_total").inc(
        int(stats.leaves_scanned))
    reg.counter(f"{prefix}.leaves_pruned_total").inc(
        int(stats.leaves_pruned))
    reg.counter(f"{prefix}.scan_bytes_total").inc(int(stats.scan_bytes))
    reg.counter(f"{prefix}.buffer_rows_total").inc(int(stats.buffer_rows))


@contextlib.contextmanager
def probe(kind: str, *, queries: int = 1, k: int = 1,
          window: Optional[int] = None, budget=None, **extra):
    """Root scope of one probe (a top-level search call).

    Yields the query-log record dict; the caller fills ``rec["stats"]``
    with the final ``SearchStats`` (and any extra keys) before the
    scope closes.  Nested probes (the sharded engine calling each
    shard's snapshot search) trace as child spans but do NOT emit their
    own query-log record or bump the probe counters — one record per
    probe, end to end.
    """
    depth = _probe_depth.get()
    outer = depth == 0
    token = _probe_depth.set(depth + 1)
    rec = {"kind": kind, "queries": int(queries), "k": int(k)}
    if window is not None:
        rec["window"] = int(window)
    b = budget_dict(budget)
    if b is not None:
        rec["budget"] = b
    rec.update(extra)
    sp = get_tracer().span("probe", kind=kind, queries=int(queries),
                           k=int(k), window=window,
                           **({"budget": b} if b else {}))
    sp.__enter__()
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        dt_ms = (time.perf_counter() - t0) * 1e3
        stats = rec.pop("stats", None)
        if stats is not None:
            attrs = _stats_attrs(stats)
            sp.set(**attrs)
            rec.update(attrs)
            timings = getattr(stats, "timings", None)
            if timings:
                rec["timings_ms"] = {n: round(v, 4)
                                     for n, v in timings.items()}
            touches = getattr(stats, "leaf_touches", None)
            if touches:
                rec["leaf_touches"] = touches
        sp.set(latency_ms=dt_ms)
        sp.__exit__(None, None, None)
        _probe_depth.reset(token)
        if outer:
            reg = get_registry()
            reg.counter("query.probes_total").inc()
            reg.counter("query.queries_total").inc(int(queries))
            reg.histogram("query.probe_latency_ms").observe(dt_ms)
            if "gap_max" in rec:
                # budgeted probes: the certified-gap distribution is an
                # SLO input (health monitors gap p95 over its window)
                reg.histogram("query.gap_max").observe(
                    float(rec["gap_max"]))
            rec["latency_ms"] = round(dt_ms, 4)
            rec.setdefault("t", time.time())
            ql = get_query_log()
            if ql is not None:
                # observers get the stamped copy the file holds, so a
                # live analyzer's seq accounting matches the log's
                rec = ql.record(rec) or rec
            for fn in list(_OBSERVERS):
                fn(rec)
