#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port of Coconut (``src/repro_torch``).

Run from the root of a checkout, on a machine with the cards the cell
asks for::

    python3 perfbench/run.py --workload tree-exact-q64 --seed 7 \\
        --seconds 45 --trace 0

It reads ``BENCHMARK.json``, finds the cell (``--workload``), its
configuration (``perfbench/configs/<name>.json``: the index kind and its
sizes), its traffic mix (``perfbench/traffic/<name>.json``, read by the
one generator in ``traffic.py``), the code for the mix's kind of traffic
(``perfbench/kinds/<kind>.py``), the system for the index kind
(``perfbench/systems/<index>.py``), the limits of its correctness numbers
(``perfbench/checks/<cell>.json``) and a reader for each metric it
reports (``perfbench/metrics/<metric>.py``, or for ``<metric>.<part>``
the reader of ``<metric>`` where there is no file of its own), all by
name, so that a cell, configuration, mix, kind of traffic or metric is
added as files and entries alone.

A run makes its data from ``--seed`` on the card, builds the index and
warms up every shape of the cell's traffic (``setup_s``), then serves the
traffic in a closed loop with one client for ``--seconds`` (to the end of
the request that crosses that time, and of the mix's unit: a whole cycle
of windows).  With ``--trace 1`` the window is profiled (the card's
operations, the program's and the harness's spans) and the line carries
the cell's per-layer metrics; with ``--trace 0`` its end-to-end ones.
After the window it reads the memory peak, judges what the window
produced against the plain reference (``reference.py``), prints each
number beside its limit on standard error and, last on standard output,
one JSON line with ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` when traced), and last ``checks``.

It exits non-zero and prints no result without the cards, outside a
checkout that holds the program, or when ``jax``, ``jaxlib``, ``flax``
or the JAX package ``repro`` was loaded.  Kernel and compiler caches stay
in ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROGRAM_TRACE_SPANS = 1 << 20


class Unavailable(RuntimeError):
    """The machine lacks what the cell needs: no result is printed."""


# ---------------------------------------------------------------------------
# finding a cell's parts by name
# ---------------------------------------------------------------------------

def load_spec(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise Unavailable(f"{path} not found")
    return json.loads(path.read_text())


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise Unavailable(f"{path} not found")
    return json.loads(path.read_text())


def resolve(spec: dict, workload: str, root: Path) -> dict:
    """The cell's entry, configuration, traffic mix and limits."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise Unavailable(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[cell["config"]]
    bench = root / spec["paths"][0]
    return {"cell": cell,
            "config": _read_json(root / entry["file"]),
            "mix": _read_json(bench / "traffic" / f"{cell['traffic']}.json"),
            "limits": _read_json(bench / "checks" / f"{workload}.json"),
            "bench": bench}


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: end-to-end ones
    untraced, per-layer ones traced (listed for the cell, or, with no
    ``workloads`` key, where the cell reports the metric they move)."""
    def listed(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in spec["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader_path(metrics_dir: Path, name: str) -> Path:
    """A metric's reader: its own file, or for ``<metric>.<part>`` the
    file of ``<metric>``."""
    own = metrics_dir / f"{name}.py"
    if own.is_file() or "." not in name:
        return own
    return metrics_dir / f"{name.split('.')[0]}.py"


def load_module(path: Path, name: str):
    if not path.is_file():
        raise Unavailable(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

class Harness:
    """What a system and a metric reader see of the run."""

    def __init__(self, torch_mod, cfg, traffic, seed, device, impl):
        self.torch = torch_mod
        self.cfg = cfg
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.impl = impl
        self.phases = {}            # set-up seconds by phase

    @staticmethod
    def clock() -> float:
        return time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase of set-up (synchronized on the card)."""
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        self.phases[name] = self.phases.get(name, 0.0) + (
            time.perf_counter() - t0)


class Window:
    """The window's record, read by the metric readers."""

    def __init__(self, records, window_s, setup_s, trace, cfg, mix):
        self.records = records      # one dict a request
        self.window_s = window_s
        self.setup_s = setup_s
        self.trace = trace          # perfbench.trace.DeviceTrace or None
        self.cfg = cfg
        self.mix = mix

    def units(self) -> int:
        return sum(r["units"] for r in self.records)


def require_chips(torch_mod, chips: int):
    if not torch_mod.cuda.is_available():
        raise Unavailable("torch.cuda.is_available() is false")
    if torch_mod.cuda.device_count() < chips:
        raise Unavailable(f"{torch_mod.cuda.device_count()} CUDA devices, "
                          f"the cell needs {chips}")
    return torch_mod.device("cuda", 0)


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _prepare(root: Path) -> None:
    """Import paths and caches: everything inside the checkout."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    if not (root / "src" / "repro_torch").is_dir():
        raise Unavailable(f"the program (src/repro_torch) is not in {root}")


def _load_kernels(torch_mod, root: Path) -> dict:
    """Build (first run in a checkout) or load the program's kernels."""
    from repro_torch.kernels import loader
    loader.BUILD_ROOT = root / "build" / "repro_torch_kernels"
    built = (loader.BUILD_ROOT / loader._digest() / loader.LIB_NAME).is_file()
    t0 = time.perf_counter()
    loader.library()
    return {"built_before": built, "seconds": time.perf_counter() - t0}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device=None, impl: str = "program",
             requests=None, t_start: float = None) -> dict:
    """One run of a cell; returns the result's fields and prints nothing.

    ``device``: None looks for the cards the cell asks for (the run of the
    benchmark); a device given skips the look (the harness's tests drive
    a run on the CPU).  ``impl="control"`` puts the reference in the
    program's place.  ``requests``: serve that many requests instead of a
    timed window (the readings of a limit)."""
    t_start = T_START if t_start is None else t_start
    root = Path(root)
    _prepare(root)
    import torch
    t_imported = time.perf_counter()
    from perfbench import traffic as traffic_mod
    from perfbench.trace import HostSpans, Recorder

    spec = load_spec(root)
    parts = resolve(spec, workload, root)
    cell, cfg, mix = parts["cell"], parts["config"], parts["mix"]
    kernels = None
    if device is None:
        device = require_chips(torch, cell["chips"])
        kernels = _load_kernels(torch, root)
    device = torch.device(device)
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    metrics = cell_metrics(spec, workload, trace)
    readers = {m["name"]: load_module(
        reader_path(parts["bench"] / "metrics", m["name"]),
        f"perfbench_metric_{m['name']}") for m in metrics}

    traffic = traffic_mod.Traffic(mix, seed)
    h = Harness(torch, cfg, traffic, seed, device, impl)
    system = load_module(parts["bench"] / "systems" / f"{cfg['index']}.py",
                         f"perfbench_system_{cfg['index']}").System(h)
    kind = load_module(parts["bench"] / "kinds" / f"{traffic.kind}.py",
                       f"perfbench_kind_{traffic.kind}").Kind(h, system)
    h.phases["imports"] = t_imported - t_start
    if kernels is not None:
        h.phases["kernels"] = kernels["seconds"]
    kind.setup()
    if on_card:
        torch.cuda.synchronize(device)
    recorder = host = None
    if trace and on_card:
        from repro_torch.obs import enable_tracing, disable_tracing
        tracer = enable_tracing(PROGRAM_TRACE_SPANS)
        disable_tracing()
        recorder, host = Recorder(torch, tracer), HostSpans()
        warnings.filterwarnings("ignore", message=".*clears events")
        recorder.start()
    setup_s = time.perf_counter() - t_start

    records = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        if requests is not None:
            if i >= requests:
                break
        elif time.perf_counter() >= deadline and traffic.unit_complete(i):
            break
        rec = kind.step(i)
        records.append(rec)
        if host is not None:
            host.add(f"request.{traffic.kind}", int(rec["t0"] * 1e9),
                     int(rec["t1"] * 1e9))
        i += 1
    if on_card:
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    dtrace = None
    if recorder is not None:
        dtrace = recorder.stop(int(t0 * 1e9), int(t1 * 1e9), host)
    win = Window(records, t1 - t0, setup_s, dtrace, cfg, mix)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    out_metrics = {}
    for m in metrics:
        v = readers[m["name"]].read(win)
        if v is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing in {workload}")
            continue
        out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    numbers = kind.checks()
    limits = parts["limits"]["numbers"]
    checks = {}
    for name, value in numbers.items():
        if name not in limits:
            raise RuntimeError(f"no limit for {name} in "
                               f"checks/{workload}.json")
        checks[name] = {"value": float(value),
                        "limit": float(limits[name]["limit"])}
    correct = bool(checks) and all(
        not math.isnan(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": win.units(), "failed": 0,
              "metrics": out_metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s()
        dev["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.top_ops(10),
                               "idle_gaps": dtrace.idle_by_host(10)}
    if kernels is not None:
        result["kernels"] = kernels
    result["setup_phases"] = h.phases
    result["observed"] = kind.observed
    result["checks"] = checks
    return result


def report(result: dict) -> None:
    """Each number beside its limit, last on standard error; the result's
    line, last on standard output."""
    for name, v in result["observed"].items():
        print(f"observed {name} {v!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except Unavailable as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad}, which the port may not use",
              file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
