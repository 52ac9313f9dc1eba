"""Unified metrics registry: counters, gauges, log-bucketed histograms.

Coconut's central claims are *cost* claims — bulk-load, query, and
update complexity in the disk-access model — so the repo is full of
counters (`IOStats` block/byte accounting, `IngestMetrics` WAL and
compaction traffic, per-query `SearchStats`).  Before this module they
were fragmented per-subsystem objects with ad-hoc snapshot methods;
the registry gives them ONE namespace, ONE thread-safety contract, and
ONE readout (:func:`describe_metrics`) the serving loop, benchmarks,
and dashboards all scrape.

Naming convention: ``subsystem.metric_unit`` — ``io.bytes_read``,
``ingest.lag_rows``, ``query.leaves_scanned_total``,
``probe.latency_ms``.  Counters are monotone totals, gauges hold the
latest observation, histograms are log2-bucketed (one ``frexp`` + one
locked list increment per observation — cheap enough for the hot path)
with p50/p95/p99 readout.

The existing telemetry objects stay as *views*: every
``IOStats``/``IngestMetrics`` update is mirrored into the registry
under its subsystem prefix (``io.*`` / ``ingest.*``), and the query
pipeline folds each ``SearchStats`` into ``query.*`` totals — existing
call sites keep working, the registry aggregates across engines,
shards, and threads.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "describe_metrics",
           "sample_percentile", "percentile_from_buckets",
           "bucket_upper_bounds"]


def sample_percentile(values: Sequence[float], p: float) -> float:
    """Exact percentile over raw samples (NaN when empty).

    THE percentile implementation for raw-sample readouts — serve.py's
    latency report and the benchmarks import this instead of keeping
    private ``_pctl`` copies; the bucketed counterpart for registry
    histograms is :func:`percentile_from_buckets` below.
    """
    import numpy as np
    if not len(values):
        return float("nan")
    return float(np.percentile(np.asarray(values), p))


class Counter:
    """Monotone total.  ``inc`` is serialized by a per-metric lock
    (``int += int`` is not atomic in CPython once threads preempt
    mid-bytecode), so concurrent increments never lose updates."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, v: int = 1) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Latest observation (ingest lag, compaction debt, shard sizes)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


# log2 bucket layout: bucket i covers [2^(i+_EXP_LO-1), 2^(i+_EXP_LO));
# 2^-20 (~1e-6) .. 2^30 (~1e9) spans sub-microsecond latencies to
# multi-gigabyte sizes in 50 buckets — 2x resolution is plenty for
# p50/p95/p99 on latency/size distributions.
_EXP_LO = -20
_EXP_HI = 30
_NBUCKETS = _EXP_HI - _EXP_LO + 2        # + underflow + overflow


def bucket_upper_bounds() -> List[float]:
    """Inclusive upper edge of every histogram bucket, in order.

    Bucket 0 (underflow) is everything <= 2^(_EXP_LO-1) including
    non-positive observations; bucket i > 0 covers
    ``(2^(i+_EXP_LO-1), 2^(i+_EXP_LO)]`` in ``le`` terms (frexp puts an
    exact power of two at the *bottom* of the next bucket, a half-open
    detail well inside the honest 2x resolution); the last bucket is the
    overflow, upper bound +inf.  This is the boundary list the
    Prometheus renderer turns into cumulative ``_bucket`` lines.
    """
    bounds = [2.0 ** (i + _EXP_LO) for i in range(_NBUCKETS - 1)]
    bounds.append(math.inf)
    return bounds


def percentile_from_buckets(counts: Sequence[int], p: float, *,
                            lo: Optional[float] = None,
                            hi: Optional[float] = None) -> float:
    """p-th percentile of a bucketed distribution (NaN when empty).

    ``counts`` is per-bucket (non-cumulative) in the registry's log2
    layout.  Interpolates to the winning bucket's geometric midpoint,
    clamped to ``[lo, hi]`` when the observed range is known — the same
    2x-honest readout as :meth:`Histogram.percentile`, factored out so
    the health monitor can compute *windowed* percentiles from bucket
    deltas between two scrapes.
    """
    total = sum(counts)
    if total == 0:
        return math.nan
    target = p / 100.0 * total
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= target and c:
            if i == 0:
                return max(0.0, lo if lo is not None else 0.0)
            blo = 2.0 ** (i + _EXP_LO - 1)
            bhi = 2.0 ** (i + _EXP_LO)
            mid = math.sqrt(blo * bhi)
            if lo is not None:
                mid = max(mid, lo)
            if hi is not None:
                mid = min(mid, hi)
            return mid
    return hi if hi is not None else math.nan


class Histogram:
    """Log2-bucketed distribution with percentile readout.

    ``observe`` costs one ``math.frexp`` and one locked list increment —
    deliberately cheap so per-probe latencies and per-scan byte counts
    can be recorded on the serving hot path.  Percentiles interpolate
    within the winning bucket (geometric midpoint), which is exact to
    within the 2x bucket width — the honest resolution of a log-bucketed
    histogram.
    """

    __slots__ = ("name", "_lock", "_counts", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counts = [0] * _NBUCKETS
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    @staticmethod
    def _bucket(v: float) -> int:
        if v <= 0.0:
            return 0
        # frexp: v = m * 2^e with m in [0.5, 1) -> bucket by exponent
        e = math.frexp(v)[1]
        return min(max(e - _EXP_LO, 0), _NBUCKETS - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        b = self._bucket(v)
        with self._lock:
            self._counts[b] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """p in [0, 100].  NaN when empty."""
        with self._lock:
            return percentile_from_buckets(self._counts, p,
                                           lo=self._min, hi=self._max)

    def buckets(self) -> Tuple[List[float], List[int]]:
        """(upper_bounds, per-bucket counts) — the full bucket layout,
        non-cumulative, aligned with :func:`bucket_upper_bounds`."""
        with self._lock:
            return bucket_upper_bounds(), list(self._counts)

    def summary(self, *, buckets: bool = False) -> Dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
        out = {"count": count, "sum": total,
               "p50": self.percentile(50), "p95": self.percentile(95),
               "p99": self.percentile(99)}
        if buckets:
            bounds, counts = self.buckets()
            out["buckets"] = [[b, c] for b, c in zip(bounds, counts)]
        return out


class MetricsRegistry:
    """Named metric store.  ``counter``/``gauge``/``histogram`` create
    on first use and return the shared instance afterwards; creation is
    serialized by the registry lock, updates by each metric's own lock
    (no global hot-path contention point)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    def reset(self) -> None:
        """Drop every metric (test isolation for the global registry)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def snapshot(self) -> Dict[str, float]:
        """Flat point-in-time view: counters and gauges by name,
        histograms expanded as ``name.count/.sum/.p50/.p95/.p99``."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        out: Dict[str, float] = {}
        for c in counters:
            out[c.name] = c.value
        for g in gauges:
            out[g.name] = g.value
        for h in hists:
            for k, v in h.summary().items():
                out[f"{h.name}.{k}"] = v
        return out

    def describe(self, *, buckets: bool = True) -> Dict[str, dict]:
        """Structured view: metrics grouped by type, histogram entries
        carrying their full bucket layout (``buckets=[[le, count],
        ...]``, non-cumulative) — what the Prometheus renderer needs to
        emit proper cumulative ``_bucket`` lines, where the flat
        :meth:`snapshot` only carries p50/p95/p99."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        return {
            "counters": {c.name: c.value for c in counters},
            "gauges": {g.name: g.value for g in gauges},
            "histograms": {h.name: h.summary(buckets=buckets)
                           for h in hists},
        }


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every subsystem mirrors into."""
    return _REGISTRY


def describe_metrics(registry: Optional[MetricsRegistry] = None, *,
                     buckets: bool = False):
    """Scrape-ready snapshot of the (global) registry — the dict the
    serving loop dumps on ``--metrics-interval`` ticks and prints at
    exit, keyed by the ``subsystem.metric_unit`` convention.

    ``buckets=True`` returns the structured form instead (counters /
    gauges / histograms grouped, histogram entries carrying their full
    ``[[le, count], ...]`` bucket layout) — the input of the Prometheus
    text renderer in an HTTP exporter.
    """
    reg = registry if registry is not None else _REGISTRY
    return reg.describe(buckets=True) if buckets else reg.snapshot()
