#!/usr/bin/env python3
"""Check the query path's stage spans on a CUDA card, and what tracing
costs, through the benchmark's own runs.

For each cell and seed it runs ``perfbench/run.py`` untraced in the
checkout ``--root`` (default: this one) and in each ``--parent`` checkout
given, then once traced in ``--root`` (and with ``--traced-parent`` in
each parent), and prints one JSON line a run.  A traced run is driven
in this process's child (``--one``), which keeps the window's device
trace and reads from it (and ``queries_per_s`` off the window, as an
untraced run reads it):

* where the kernels ran: the share of ``MindistBatch`` launches that lie
  wholly inside a ``bound`` span, of ``euclid_cross_kernel`` launches
  inside a ``verify`` or ``buffer`` span, and of ``euclid_gather_kernel``
  launches inside a ``seed.distances`` span, with the spans moved onto
  the profiler's clock by the harness's one offset;
* for each half second, the shift of the device's clock that would put
  the most launches inside, beside how far the system clock moved from
  ``perf_counter`` since that offset was read (sampled every 20 ms);
* the share of each kernel's launch calls (the profiler's CUDA runtime
  events, matched by correlation id, stamped on the host) inside its
  stage spans, and per half second the delay from launch to kernel;
* ``Tracer.dropped`` at the window's end, the spans recorded, each
  stage's summed span seconds, and the idle device time by innermost
  span, every span named.

The card's name and power limit come first, with what one empty stage
costs on the card's host, tracing off and on.  From the repository
root::

    python3 tools/chip_stages.py --cells tree-exact-q64 --seeds 11,12 \\
        --seconds 51 --parent build/parent --out chiprun_out/stages.jsonl
"""
from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PLACED = {"MindistBatch": ("bound",),
          "euclid_cross_kernel": ("verify", "buffer"),
          "euclid_gather_kernel": ("seed.distances",)}
STAGES = ("plan", "seed", "seed.window", "seed.distances", "bound",
          "verify", "merge", "buffer", "frontier", "progress", "snapshot",
          "scan", "prune")


def _inside(ops, spans):
    """(launches, launches wholly inside one of ``spans``); spans of one
    thread's stages do not overlap, so the last to start before a launch
    is the only one that can hold it."""
    spans = sorted(spans)
    starts = [s for s, _ in spans]
    n = hit = 0
    for s, e in ops:
        n += 1
        i = bisect.bisect_right(starts, s) - 1
        hit += i >= 0 and spans[i][1] >= e
    return n, hit


def _shifted(ops, spans, shifts_ns):
    """Launches wholly inside a span with every launch moved by each of
    ``shifts_ns``: ``[len(shifts_ns)]`` counts."""
    import numpy as np
    sp = np.array(sorted(spans), np.int64).reshape(-1, 2)
    op = np.array(ops, np.int64).reshape(-1, 2)
    out = []
    for d in shifts_ns:
        i = np.searchsorted(sp[:, 0], op[:, 0] + d, side="right") - 1
        ok = (i >= 0) & (sp[np.maximum(i, 0), 1] >= op[:, 1] + d)
        out.append(int(ok.sum()))
    return out


def placement(dt, bins: int = 8) -> dict:
    """Each kernel's share inside its stage spans; and, in each eighth of
    the window, the shift of the device's clock (us, -2000..2000) that
    puts the most launches inside, with the share it gives: a shift that
    moves through the window is drift between the clocks."""
    out = {}
    shifts = list(range(-2_000_000, 2_000_001, 5_000))
    for needle, names in PLACED.items():
        ops = [(s, e) for name, s, e in dt.ops if needle in name]
        spans = [(s, e) for name, s, e, d in dt.spans
                 if d >= 1 and name in names]
        n, hit = _inside(ops, spans)
        by_bin = []
        w = max(1, dt.t1_ns - dt.t0_ns)
        for b in range(bins):
            part = [o for o in ops if (o[0] - dt.t0_ns) * bins // w == b]
            if not part or not spans:
                continue
            c = _shifted(part, spans, shifts)
            k = max(range(len(c)), key=lambda j: (c[j], -abs(shifts[j])))
            by_bin.append([b, len(part), c[shifts.index(0)] / len(part),
                           shifts[k] / 1e3, c[k] / len(part)])
        out[needle] = {"launches": n, "inside": hit,
                       "share": hit / n if n else None, "spans": names,
                       "by_eighth": by_bin}
    return out


def clock_steps(dt, samples, offset, bin_ns: int = 500_000_000) -> list:
    """Per half second of the window: the launches of the three kernels,
    their share inside their spans, the one shift of the device's clock
    (us) that puts the most inside and its share, and beside it how far
    the system clock had moved from the perf_counter clock since the
    trace's one offset was read (us, mean of the samples in the bin:
    the harness maps spans by that offset)."""
    ops, spans = [], {}
    for needle, names in PLACED.items():
        ops += [(needle, s, e) for name, s, e in dt.ops if needle in name]
        spans[needle] = [(s, e) for name, s, e, d in dt.spans
                         if d >= 1 and name in names]
    shifts = list(range(-3_000_000, 3_000_001, 5_000))
    out = []
    for b in range(0, max(1, (dt.t1_ns - dt.t0_ns) // bin_ns + 1)):
        lo = dt.t0_ns + b * bin_ns
        part = [o for o in ops if lo <= o[1] < lo + bin_ns]
        if not part:
            continue
        c = [0] * len(shifts)
        for needle in PLACED:
            mine = [(s, e) for k, s, e in part if k == needle]
            if mine and spans[needle]:
                c = [x + y for x, y in
                     zip(c, _shifted(mine, spans[needle], shifts))]
        k = max(range(len(c)), key=lambda j: (c[j], -abs(shifts[j])))
        dev = [(t - p - offset) / 1e3 for p, t, _ in samples
               if lo <= p + offset < lo + bin_ns]
        out.append([round(b * bin_ns / 1e9, 1), len(part),
                    round(c[shifts.index(0)] / len(part), 4),
                    shifts[k] / 1e3, round(c[k] / len(part), 4),
                    round(sum(dev) / len(dev), 1) if dev else None])
    return out


def launches(prof, dt, bin_ns: int = 500_000_000) -> dict:
    """Where each kernel's launch call (the profiler's CUDA runtime event
    of the same correlation id, stamped on the host) lies: the share
    inside the kernel's stage spans, and per half second the median,
    least and most delay from the launch call's start to the kernel's
    start (us).  A launch inside its span with a delay that wanders
    says the device's timestamps, not the spans, are off."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    try:
        evs = list(prof.profiler.kineto_results.events())
        cpu = {}
        for e in evs:
            if e.device_type() != cuda and "Launch" in e.name():
                cpu[e.correlation_id()] = (e.start_ns(), e.end_ns())
        out = {}
        for needle, names in PLACED.items():
            spans = sorted((s, e) for name, s, e, d in dt.spans
                           if d >= 1 and name in names)
            pairs = [(cpu[e.correlation_id()], e.start_ns()) for e in evs
                     if e.device_type() == cuda and needle in e.name()
                     and e.correlation_id() in cpu]
            n, hit = _inside([lc for lc, _ in pairs], spans)
            delay = []
            for b in range(0, (dt.t1_ns - dt.t0_ns) // bin_ns + 1):
                lo = dt.t0_ns + b * bin_ns
                d = sorted((k - lc[0]) / 1e3 for lc, k in pairs
                           if lo <= lc[0] < lo + bin_ns)
                if d:
                    delay.append([round(b * bin_ns / 1e9, 1),
                                  round(d[len(d) // 2], 1), round(d[0], 1),
                                  round(d[-1], 1)])
            out[needle] = {"matched": n, "inside": hit,
                           "share": hit / n if n else None,
                           "delay_us": delay}
        return out
    except (AttributeError, RuntimeError, TypeError) as exc:
        return {"error": repr(exc)}


def one(root: Path, workload: str, seed: int, seconds: float) -> int:
    """One traced run in ``root``, with the placement read off its trace."""
    sys.path[:0] = [str(root), str(root / "src")]
    import threading
    from perfbench import run, trace
    kept = {}
    stop = trace.Recorder.stop
    start = trace.Recorder.start
    samples = []
    done = threading.Event()

    def sample():
        while not done.wait(0.02):
            samples.append((time.perf_counter_ns(), time.time_ns(),
                            time.clock_gettime_ns(time.CLOCK_MONOTONIC_RAW)))

    def begin(self):
        start(self)
        kept["offset"] = self.offset

    def keep(self, *a, **kw):
        kept["dt"] = stop(self, *a, **kw)
        kept["launches"] = launches(self.prof, kept["dt"])
        return kept["dt"]

    class Window(run.Window):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept["win"] = self

    trace.Recorder.start = begin
    trace.Recorder.stop = keep
    run.Window = Window
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        result = run.run_cell(workload, seed, seconds, True, root=root)
    finally:
        done.set()
        sampler.join(5)
    qps = run.load_module(root / "perfbench/metrics/queries_per_s.py",
                          "chip_stages_qps").read(kept["win"])
    from repro_torch.obs import get_tracer
    tr = get_tracer()
    dt = kept["dt"]
    prog = [(n, s, e) for n, s, e, d in dt.spans if d >= 1]
    stage_s = {n: sum(e - s for m, s, e in prog if m == n) / 1e9
               for n in STAGES}
    print(json.dumps({
        "workload": workload, "seed": seed, "trace": 1,
        "queries_per_s": qps, "metrics": result["metrics"],
        "correct": result["correct"], "device": result["device"],
        "placement": placement(dt), "dropped": tr.dropped,
        "spans": len(prog), "stage_s": stage_s,
        "idle_by_span": dt.idle_by_host(40),
        "clock_steps": clock_steps(dt, samples, kept["offset"]),
        "launches": kept["launches"],
        "device_ops": dt.top_ops(12)}), flush=True)
    return 0


def stage_cost(n: int = 200_000) -> dict:
    """Microseconds one empty ``obs.stage`` costs, tracing off and on
    (the best of five rounds of ``n``, from an empty ring)."""
    sys.path[:0] = [str(ROOT / "src")]
    from types import SimpleNamespace
    from repro_torch.obs import disable_tracing, enable_tracing, stage
    st = SimpleNamespace(timings={})
    out = {}
    for label, on in (("off", False), ("on", True)):
        tr = enable_tracing(1 << 20) if on else None
        if not on:
            disable_tracing()
        best = float("inf")
        for _ in range(5):
            if tr is not None:
                tr.clear()
            t0 = time.perf_counter()
            for _ in range(n):
                with stage(st, "bound", rows=1):
                    pass
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
        out[label] = best
    disable_tracing()
    return out


def _run(cmd, cwd) -> dict:
    t0 = time.time()
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[-1]) if lines else {}
    rec["rc"] = p.returncode
    rec["wall_s"] = time.time() - t0
    if p.returncode:
        rec["stderr"] = p.stderr[-3000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", required=False, default="")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--parent", action="append", default=[])
    ap.add_argument("--traced-parent", action="store_true",
                    help="also a traced run a seed in each --parent")
    ap.add_argument("--untraced", type=int, choices=(0, 1), default=1)
    ap.add_argument("--traced", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default="")
    ap.add_argument("--one", nargs=3, metavar=("WORKLOAD", "SEED", "SECONDS"))
    a = ap.parse_args(argv)
    if a.one:
        return one(Path(a.root), a.one[0], int(a.one[1]), float(a.one[2]))
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    except FileNotFoundError:
        smi = "no nvidia-smi"
    print(json.dumps({"card": smi, "stage_us": stage_cost()}), flush=True)
    out = open(a.out, "a") if a.out else None
    try:
        _drive(a, out)
    finally:
        if out is not None:
            out.close()
    return 0


def _drive(a, out) -> None:
    """Every cell and seed: the untraced runs of each side, then the
    traced ones, a JSON line each (in full to ``out``, short here)."""
    me = str(Path(__file__).resolve())
    root = str(Path(a.root).resolve())
    sides = [("change", root)] + [(f"parent{i}", str(Path(p).resolve()))
                                  for i, p in enumerate(a.parent)]
    for cell in [c for c in a.cells.split(",") if c]:
        for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
            # alternate which side runs first, seed by seed
            order = sides if i % 2 == 0 else sides[::-1]
            runs = []
            if a.untraced:
                runs += [(name, where, 0) for name, where in order]
            if a.traced:
                runs.append(("change", root, 1))
            if a.traced_parent:
                runs += [(name, where, 1) for name, where in sides[1:]]
            for name, where, traced in runs:
                if traced:
                    cmd = [sys.executable, me, "--root", where, "--one",
                           cell, str(seed), str(a.seconds)]
                else:
                    cmd = [sys.executable, "perfbench/run.py", "--workload",
                           cell, "--seed", str(seed), "--seconds",
                           str(a.seconds), "--trace", str(traced)]
                rec = _run(cmd, where)
                rec.update(side=name, workload=cell, seed=seed, trace=traced)
                m = rec.get("metrics", {})
                if "queries_per_s" in m:
                    rec["queries_per_s"] = m["queries_per_s"]["value"]
                rec.setdefault("queries_per_s", None)
                line = json.dumps(rec)
                if out is not None:
                    out.write(line + "\n")
                    out.flush()
                short = {k: rec.get(k) for k in (
                    "side", "workload", "seed", "trace", "rc", "correct",
                    "queries_per_s", "dropped", "wall_s")}
                if traced:
                    short["placement"] = {
                        k: v["share"] for k, v in
                        rec.get("placement", {}).items()}
                    short["metrics"] = {k: v["value"] for k, v in
                                        m.items()}
                    short["clock_steps"] = rec.get("clock_steps")
                    short["idle"] = (rec.get("idle_by_span")
                                     or rec.get("breakdown", {})
                                     .get("idle_gaps"))
                print(json.dumps(short), flush=True)


if __name__ == "__main__":
    sys.exit(main())
