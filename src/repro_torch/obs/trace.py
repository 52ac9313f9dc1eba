"""Per-query trace spans: a context-propagated span tree over the
serving path, exported as Chrome/Perfetto ``trace_event`` JSON.

Answers "where did this query's 9 ms go?": every probe opens a root
span, and each host stage of a search is one span, so that every host
step inside a search call lies in one:

* ``plan`` — the queries' PAA and the planner (window cut, leaf bounds);
* ``seed`` — one sorted partition's seed probe, with its children
  ``seed.window`` (query summaries, z-order keys, key search, copy
  back), ``seed.distances`` (gathered ED, copy back, the ``alive``
  mask) and ``merge``;
* ``scan`` — one partition (or, in the budgeted drain, one leaf group),
  holding ``prune`` and, a leaf group at a time, ``bound`` (row indices,
  code gather, bound launch, copy back, live mask), ``verify`` (row
  gather, ED or fused launch, copy back) and ``merge`` (host ``KnnPool``
  updates); where the partition's pools stay on its device, the three
  time the host's issue of the group's launches (``merge``: the
  ``pool_merge`` fold) and the partition's one wait is ``sync`` (the
  pools and counters copied back);
* ``buffer`` — an unsorted buffer's brute-force scan (copy to the
  device, ED, sort, copy back), its ``merge`` a child;
* ``frontier`` and ``progress`` — the budgeted drain's global leaf
  order, and each progressive snapshot (gap report and copies);
* ``snapshot`` — an LSM read view's capture (runs, the buffer's
  concatenation, key fences), outside the probe it serves;
* ``compact.*`` — the LSM's flushes, merges and commits; the sharded
  engine adds one ``shard`` span per fan-out plus a ``merge`` span.

Each span records the accounting of its stage — leaves pruned/scanned,
bytes charged, budget consumption, certified gap — as ``args``.
Per-span ``leaves_scanned``/``scan_bytes`` sum to the probe's
``SearchStats`` totals by construction (they are deltas of the same
counters).  A stage opened through :func:`stage` is also the stage's
``SearchStats.timings`` entry: one pair of clock readings gives both the
span's duration and the milliseconds added to the timing.

Design constraints, in order:

* **Hot-path cost.**  Tracing is off by default; a disabled tracer
  hands out one shared no-op span, so the instrumentation costs one
  attribute check per call site (a stage: its two ``perf_counter``
  calls, which its timing needs anyway, and that check).  Enabled spans
  cost two ``perf_counter`` calls and one tuple append.
* **Bounded memory.**  Finished spans land in a ring buffer
  (``collections.deque(maxlen=...)``) — sustained serving overwrites
  the oldest spans instead of growing without bound.
* **Context propagation.**  The parent pointer rides a
  ``contextvars.ContextVar``, so nesting is automatic within a thread
  (and across ``asyncio`` tasks); worker threads (compactor, router
  fan-out) start their own roots under their own ``tid``, which is
  exactly how Perfetto renders concurrent tracks.

Export is the Chrome ``trace_event`` JSON object format (``ph: "X"``
complete events with microsecond ``ts``/``dur``): load the file at
https://ui.perfetto.dev or chrome://tracing as-is.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "get_tracer", "enable_tracing",
           "disable_tracing", "span", "stage"]

_current: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("coconut_span", default=None)


class _NopSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        pass


_NOP = _NopSpan()


class Span:
    """One timed stage.  ``set(**args)`` attaches attributes (leaf
    counts, byte charges, budget state) that export as trace-event
    ``args`` — visible in the Perfetto span detail pane."""

    __slots__ = ("tracer", "name", "args", "span_id", "parent_id",
                 "tid", "t0_us", "dur_us", "_token", "_t")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.span_id = 0
        self.parent_id = 0
        self.tid = 0
        self.t0_us = 0.0
        self.dur_us = 0.0
        self._token = None
        self._t = 0.0

    def set(self, **args) -> None:
        self.args.update(args)

    def __enter__(self) -> "Span":
        self._link()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._finish(self._t, time.perf_counter() - self._t)
        return False

    def _link(self) -> None:
        """Take an id and become the context's current span."""
        self.span_id = next(self.tracer._ids)
        parent = _current.get()
        self.parent_id = parent.span_id if parent is not None else 0
        self.tid = threading.get_ident() & 0x7FFFFFFF
        self._token = _current.set(self)

    def _finish(self, t0: float, dt: float) -> None:
        """Close at ``perf_counter`` reading ``t0`` plus ``dt`` seconds."""
        self.t0_us = (t0 - self.tracer.epoch) * 1e6
        self.dur_us = dt * 1e6
        _current.reset(self._token)
        self.tracer._record(self)


class _Stage:
    """A host stage: its milliseconds go to ``timings[name]`` and, while
    tracing is on, a span takes the same two clock readings."""

    __slots__ = ("timings", "name", "args", "span", "t0")

    def __init__(self, timings, name: str, args: Dict):
        self.timings = timings
        self.name = name
        self.args = args
        self.span = None

    def __enter__(self):
        if not _TRACER.enabled:
            self.t0 = time.perf_counter()
            return _NOP
        sp = self.span = Span(_TRACER, self.name, self.args)
        sp._link()
        self.t0 = time.perf_counter()
        return sp

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self.t0
        t = self.timings
        if t is not None:
            t[self.name] = t.get(self.name, 0.0) + dt * 1e3
        if self.span is not None:
            self.span._finish(self.t0, dt)
        return False


class Tracer:
    """Span factory + bounded ring buffer of finished spans."""

    def __init__(self, capacity: int = 65536):
        self.enabled = False
        self.capacity = capacity
        self.epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        # ids without a lock: ``next`` on a count is one step under the
        # interpreter lock, so ids stay unique across threads
        self._ids = itertools.count(1)
        self.dropped = 0          # spans overwritten by the ring bound

    def _record(self, sp: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append((sp.name, sp.span_id, sp.parent_id, sp.tid,
                               sp.t0_us, sp.dur_us, sp.args))

    # ------------------------------------------------------------- interface
    def span(self, name: str, **args):
        """Open a span (context manager).  No-op while disabled."""
        if not self.enabled:
            return _NOP
        return Span(self, name, args)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def spans(self) -> List[dict]:
        """Finished spans, oldest first (structured, for tests and the
        query log — the export format is :meth:`export_chrome`)."""
        with self._lock:
            ring = list(self._ring)
        return [{"name": n, "id": i, "parent": p, "tid": t, "ts": ts,
                 "dur": d, "args": a} for n, i, p, t, ts, d, a in ring]

    # ---------------------------------------------------------------- export
    def export_chrome(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object format: complete
        (``ph: "X"``) events with microsecond timestamps, plus process/
        thread metadata so tracks get readable names."""
        spans = self.spans()
        events = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                   "args": {"name": "coconut"}}]
        tids = sorted({s["tid"] for s in spans})
        for t in tids:
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": t, "args": {"name": f"thread-{t}"}})
        for s in spans:
            args = {k: _jsonable(v) for k, v in s["args"].items()}
            args["span_id"] = s["id"]
            if s["parent"]:
                args["parent_id"] = s["parent"]
            events.append({"name": s["name"], "ph": "X", "pid": 1,
                           "tid": s["tid"], "ts": round(s["ts"], 3),
                           "dur": round(s["dur"], 3), "cat": "coconut",
                           "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped}}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export_chrome(), f)
            f.write("\n")


def _jsonable(v):
    """Span args arrive as numpy scalars/arrays; exports must be JSON."""
    try:
        import numpy as np
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.generic):
            return v.item()
    except ImportError:                       # pragma: no cover
        pass
    return v


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer the pipeline instruments against."""
    return _TRACER


def enable_tracing(capacity: Optional[int] = None) -> Tracer:
    """Turn the global tracer on (optionally resizing the ring)."""
    if capacity is not None and capacity != _TRACER.capacity:
        _TRACER.capacity = capacity
        with _TRACER._lock:
            _TRACER._ring = deque(_TRACER._ring, maxlen=capacity)
    _TRACER.enable()
    return _TRACER


def disable_tracing() -> None:
    _TRACER.disable()


def span(name: str, **args):
    """Module-level convenience: a span on the global tracer."""
    return _TRACER.span(name, **args)


def stage(stats, name: str, **args):
    """Time one host stage of a search (context manager).

    The clock is read once at entry and once at exit; the milliseconds
    between go to ``stats.timings[name]`` (``stats``: anything with a
    ``timings`` dict, e.g. a ``SearchStats``; None times nothing), and
    while tracing is on a span named ``name`` with ``args`` records the
    same two readings, so a stage's span duration and its timing are one
    measurement.  Yields the span (the shared no-op span while tracing
    is off) for ``set(**args)``."""
    return _Stage(None if stats is None else stats.timings, name, args)
