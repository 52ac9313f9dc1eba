"""Reading a traced window: device time from ``torch.profiler``, host
activity from spans.

The profiler records the card only (CUDA activity: kernels, copies,
fills); host activity comes from spans, both the harness's own (one a
request) and the program's (``repro_torch.obs`` spans: ``plan``,
``seed``, ``prune``, ``scan``, ``verify``, ``compact.flush``, ...), which
cost far less than the profiler's record of every host operation.  The
profiler stamps events in nanoseconds of the system clock; spans are
taken on ``time.perf_counter``, moved onto that clock by one offset read
when the trace starts.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Dict, List, Tuple

NAME_CHARS = 100       # a device operation's name is cut to this length


def clock_offset_ns() -> int:
    """system clock ns - perf_counter ns, read back to back."""
    a = time.perf_counter_ns()
    t = time.time_ns()
    b = time.perf_counter_ns()
    return t - (a + b) // 2


class HostSpans:
    """The harness's spans: (name, start ns, end ns) on perf_counter."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []

    def add(self, name: str, t0_ns: int, t1_ns: int) -> None:
        self.spans.append((name, t0_ns, t1_ns))


class DeviceTrace:
    """The device's operations in a window, and the host spans beside
    them, all on the system clock in ns."""

    def __init__(self, ops: List[Tuple[str, int, int]], t0_ns: int,
                 t1_ns: int, spans: List[Tuple[str, int, int, int]]):
        self.ops = ops            # (name, start, end)
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.spans = spans        # (name, start, end, depth)
        self._union = None

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def union(self) -> List[Tuple[int, int]]:
        """Disjoint busy intervals, clipped to the window."""
        if self._union is None:
            iv = sorted((max(s, self.t0_ns), min(e, self.t1_ns))
                        for _, s, e in self.ops)
            out: List[List[int]] = []
            for s, e in iv:
                if e <= s:
                    continue
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            self._union = [tuple(x) for x in out]
        return self._union

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) / 1e9

    def op_seconds(self, *needles: str) -> Tuple[float, int]:
        """(seconds, launches) of the operations whose name holds any of
        ``needles``."""
        t, n = 0, 0
        for name, s, e in self.ops:
            if any(k in name for k in needles):
                t += e - s
                n += 1
        return t / 1e9, n

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, int] = defaultdict(int)
        for name, s, e in self.ops:
            tot[name[:NAME_CHARS]] += e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle device time in the window, summed by what the host was
        doing in each gap: the innermost span that holds the gap's
        midpoint ("outside spans" where none does)."""
        gaps = []
        prev = self.t0_ns
        for s, e in self.union():
            if s > prev:
                gaps.append((prev, s))
            prev = e
        if self.t1_ns > prev:
            gaps.append((prev, self.t1_ns))
        spans = sorted(self.spans, key=lambda x: x[1])
        tot: Dict[str, int] = defaultdict(int)
        active: List[Tuple[int, int, int, str]] = []    # heap by end
        i = 0
        for g0, g1 in gaps:                 # gaps come in time order
            mid = (g0 + g1) // 2
            while i < len(spans) and spans[i][1] <= mid:
                name, s, e, d = spans[i]
                heapq.heappush(active, (e, -d, s, name))
                i += 1
            while active and active[0][0] <= mid:
                heapq.heappop(active)
            best = max(active, key=lambda a: (-a[1], a[2]), default=None)
            tot["outside spans" if best is None else best[3]] += g1 - g0
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


class Recorder:
    """Profiles the card over a window (``torch.profiler``, CUDA activity
    only) and gathers the host spans beside it."""

    def __init__(self, torch_mod, program_tracer=None):
        self.torch = torch_mod
        self.tracer = program_tracer
        self.prof = None
        self.offset = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        if self.tracer is not None:
            self.tracer.clear()
            self.tracer.enable()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.offset = clock_offset_ns()

    def stop(self, t0_perf_ns: int, t1_perf_ns: int,
             host: HostSpans) -> DeviceTrace:
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        if self.tracer is not None:
            self.tracer.disable()
        cuda = self.torch.autograd.DeviceType.CUDA
        ops = [(e.name(), e.start_ns(), e.end_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        off = self.offset
        spans = [(name, s + off, e + off, 0) for name, s, e in host.spans]
        if self.tracer is not None:
            ep = int(self.tracer.epoch * 1e9) + off
            depth = _depths(self.tracer.spans())
            for sp in self.tracer.spans():
                s = ep + int(sp["ts"] * 1e3)
                spans.append((sp["name"], s, s + int(sp["dur"] * 1e3),
                              1 + depth.get(sp["id"], 0)))
        return DeviceTrace(ops, t0_perf_ns + off, t1_perf_ns + off, spans)


def _depths(spans: List[dict]) -> Dict[int, int]:
    parent = {s["id"]: s["parent"] for s in spans}
    out: Dict[int, int] = {}
    for sid in parent:
        d, p = 0, parent[sid]
        while p and d < 64:
            d += 1
            p = parent.get(p, 0)
        out[sid] = d
    return out

