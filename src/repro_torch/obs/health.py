"""Live health / SLO monitoring over the metrics registry.

A :class:`HealthMonitor` samples the system on a fixed cadence and
evaluates a set of SLO checks over a **rolling window** (not the
process lifetime — a latency spike an hour ago must not pin the system
red forever):

* ``probe_p99_ms`` — windowed p99 of ``query.probe_latency_ms``,
  computed from histogram *bucket deltas* between the oldest and newest
  sample in the window (the registry histogram is cumulative; the
  difference of two scrapes is the distribution of exactly the probes
  that landed in between);
* ``gap_p95`` — same windowed readout over ``query.gap_max`` (budgeted
  probes' certified gap: is the approximate dial still honest);
* ``ingest_lag_rows`` / ``compaction_debt`` — engine gauges, sampled
  via caller-provided callables (latest value wins: they are levels,
  not rates);
* ``backpressure_waits_per_s`` — windowed rate of the
  ``ingest.backpressure_waits`` counter.

Each check maps through a :class:`Threshold` (degraded, critical; higher
is worse) and the overall state is the worst individual one:
``ok`` → ``degraded`` → ``critical``.  Every state *transition* appends
a structured alert event to ``health_events.jsonl`` in the query-log
directory (same JSONL discipline as the query log), so the maintenance
loop — and CI — can replay exactly when and why the system degraded.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from .registry import (MetricsRegistry, get_registry,
                       percentile_from_buckets)

__all__ = ["Threshold", "HealthMonitor", "DEFAULT_THRESHOLDS",
           "STATES"]

STATES = ("ok", "degraded", "critical")


@dataclasses.dataclass(frozen=True)
class Threshold:
    """Degraded/critical cut points for one check (higher is worse;
    a value must *exceed* the cut to trip it).  ``inf`` disables a
    level."""
    degraded: float
    critical: float = math.inf

    def state(self, value: Optional[float]) -> str:
        if value is None or (isinstance(value, float)
                             and math.isnan(value)):
            return "ok"               # no signal yet: not an alert
        if value > self.critical:
            return "critical"
        if value > self.degraded:
            return "degraded"
        return "ok"


DEFAULT_THRESHOLDS: Dict[str, Threshold] = {
    "probe_p99_ms": Threshold(500.0, 5000.0),
    "ingest_lag_rows": Threshold(50_000.0, 500_000.0),
    "compaction_debt": Threshold(8.0, 64.0),
    "backpressure_waits_per_s": Threshold(1.0, 25.0),
    "gap_p95": Threshold(math.inf, math.inf),   # opt-in: workload units
}

_WORST = {s: i for i, s in enumerate(STATES)}


class HealthMonitor:
    """Rolling-window SLO evaluation with state-transition alerts.

    ``sources`` maps gauge-style check names (``ingest_lag_rows``,
    ``compaction_debt``) to zero-arg callables; histogram/counter checks
    read the registry directly.  :meth:`start` runs the sampler on a
    daemon thread; a server can instead call :meth:`sample` +
    :meth:`evaluate` on demand (every evaluation also appends alert
    events on transitions).
    """

    def __init__(self, *,
                 thresholds: Optional[Dict[str, Threshold]] = None,
                 sources: Optional[Dict[str, Callable[[], float]]] = None,
                 window_s: float = 30.0,
                 interval_s: float = 0.5,
                 events_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.thresholds = dict(DEFAULT_THRESHOLDS)
        if thresholds:
            self.thresholds.update(thresholds)
        self.sources = dict(sources or {})
        self.window_s = float(window_s)
        self.interval_s = float(interval_s)
        self.events_dir = events_dir
        self._registry = registry
        self._lock = threading.Lock()
        self._samples: List[dict] = []      # time-ordered window
        self._state = "ok"
        self.transitions = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def registry(self) -> MetricsRegistry:
        return (self._registry if self._registry is not None
                else get_registry())

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    # -------------------------------------------------------------- sampling
    def sample(self) -> dict:
        """Capture one observation (registry histogram buckets, counter
        values, source gauges) and trim the window."""
        reg = self.registry
        s: dict = {"t": time.monotonic()}
        for hname in ("query.probe_latency_ms", "query.gap_max"):
            _, counts = reg.histogram(hname).buckets()
            s[hname] = counts
        s["ingest.backpressure_waits"] = \
            reg.counter("ingest.backpressure_waits").value
        for name, fn in self.sources.items():
            try:
                s[name] = float(fn())
            except Exception:
                s[name] = None          # a dead source is not a crash
        with self._lock:
            self._samples.append(s)
            cutoff = s["t"] - self.window_s
            # keep one sample at/before the cutoff as the window base
            while len(self._samples) >= 2 \
                    and self._samples[1]["t"] <= cutoff:
                self._samples.pop(0)
        return s

    @staticmethod
    def _windowed_pctl(new: dict, old: dict, hname: str,
                       p: float) -> float:
        delta = [a - b for a, b in zip(new[hname], old[hname])]
        return percentile_from_buckets(delta, p)

    def values(self) -> Dict[str, Optional[float]]:
        """Current check values over the rolling window (NaN/None when
        there is no signal)."""
        with self._lock:
            if not self._samples:
                return {name: None for name in self.thresholds}
            new = self._samples[-1]
            old = self._samples[0]
        dt = max(new["t"] - old["t"], 1e-9)
        out: Dict[str, Optional[float]] = {}
        for name in self.thresholds:
            if name == "probe_p99_ms":
                out[name] = self._windowed_pctl(
                    new, old, "query.probe_latency_ms", 99)
            elif name == "gap_p95":
                out[name] = self._windowed_pctl(
                    new, old, "query.gap_max", 95)
            elif name == "backpressure_waits_per_s":
                waits = (new["ingest.backpressure_waits"]
                         - old["ingest.backpressure_waits"])
                # single sample: a rate needs a window; report 0
                out[name] = waits / dt if new is not old else 0.0
            else:
                out[name] = new.get(name)
        return out

    # ------------------------------------------------------------ evaluation
    def evaluate(self, *, sample_first: bool = True) -> dict:
        """One SLO evaluation (optionally sampling first).  Returns the
        health document served at ``/health`` and appends an alert
        event when the overall state changed."""
        if sample_first:
            self.sample()
        values = self.values()
        checks = {}
        worst = "ok"
        for name, th in self.thresholds.items():
            v = values.get(name)
            st = th.state(v)
            checks[name] = {
                "value": (None if v is None
                          or (isinstance(v, float) and math.isnan(v))
                          else round(float(v), 4)),
                "state": st,
                "degraded_above": (None if math.isinf(th.degraded)
                                   else th.degraded),
                "critical_above": (None if math.isinf(th.critical)
                                   else th.critical),
            }
            if _WORST[st] > _WORST[worst]:
                worst = st
        doc = {"state": worst, "window_s": self.window_s,
               "checks": checks, "t": time.time()}
        with self._lock:
            prev, self._state = self._state, worst
        if worst != prev:
            with self._lock:
                self.transitions += 1
            self._emit_event(prev, worst, checks)
        return doc

    def _emit_event(self, prev: str, cur: str, checks: dict) -> None:
        if self.events_dir is None:
            return
        ev = {"t": time.time(), "event": "health_transition",
              "from": prev, "to": cur,
              "failing": {n: c for n, c in checks.items()
                          if c["state"] != "ok"}}
        try:
            os.makedirs(self.events_dir, exist_ok=True)
            with open(os.path.join(self.events_dir,
                                   "health_events.jsonl"), "a") as f:
                f.write(json.dumps(ev, separators=(",", ":")) + "\n")
        except OSError:
            pass                        # alerting must never take down serving

    # --------------------------------------------------------------- lifetime
    def start(self) -> "HealthMonitor":
        """Run ``evaluate()`` every ``interval_s`` on a daemon thread."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.evaluate()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="coconut-health")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
