"""Per-query trace spans: a context-propagated span tree over the
serving path, exported as Chrome/Perfetto ``trace_event`` JSON.

Answers "where did this query's 9 ms go?": every probe opens a root
span, the planner/executor/drain open ``plan`` / ``prune`` / ``scan`` /
``verify`` children (and the sharded engine one ``shard`` span per
fan-out plus a ``merge`` span), and each span records the accounting
of its stage — leaves pruned/scanned, bytes charged, budget
consumption, certified gap — as ``args``.  Per-span
``leaves_scanned``/``scan_bytes`` sum to the probe's ``SearchStats``
totals by construction (they are deltas of the same counters).

Design constraints, in order:

* **Hot-path cost.**  Tracing is off by default; a disabled tracer
  hands out one shared no-op span, so the instrumentation costs one
  attribute check per call site.  Enabled spans cost two
  ``perf_counter`` calls and one dict append.
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
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "get_tracer", "enable_tracing",
           "disable_tracing", "span"]

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
                 "tid", "t0_us", "dur_us", "_token")

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

    def set(self, **args) -> None:
        self.args.update(args)

    def __enter__(self) -> "Span":
        tr = self.tracer
        self.span_id = tr._next_id()
        parent = _current.get()
        self.parent_id = parent.span_id if parent is not None else 0
        self.tid = threading.get_ident() & 0x7FFFFFFF
        self._token = _current.set(self)
        self.t0_us = (time.perf_counter() - tr.epoch) * 1e6
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_us = (time.perf_counter() - self.tracer.epoch) * 1e6 \
            - self.t0_us
        _current.reset(self._token)
        self.tracer._record(self)
        return False


class Tracer:
    """Span factory + bounded ring buffer of finished spans."""

    def __init__(self, capacity: int = 65536):
        self.enabled = False
        self.capacity = capacity
        self.epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._id = 0
        self.dropped = 0          # spans overwritten by the ring bound

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _record(self, sp: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(
                {"name": sp.name, "id": sp.span_id,
                 "parent": sp.parent_id, "tid": sp.tid,
                 "ts": sp.t0_us, "dur": sp.dur_us, "args": sp.args})

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
            return list(self._ring)

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
