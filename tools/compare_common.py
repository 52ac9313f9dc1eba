"""What the side-by-side kernel comparisons (``compare_cross.py``,
``compare_mindist.py``) share: loading several checkouts' ``repro_torch``
in one process, and the event and host timers.
"""
from __future__ import annotations

import importlib
import importlib.util
import statistics
import sys
import time
from pathlib import Path

import torch

EVENT_REPS = 200
SLEEP_CYCLES = 2_000_000       # about 1 ms of device sleep


def load(src: str, alias: str, modules: dict) -> dict:
    """``modules`` (name -> module path in the package) of the
    ``repro_torch`` package under ``src``, imported as the package
    ``alias`` so that several trees' packages live side by side."""
    pkg = Path(src).resolve() / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return {name: importlib.import_module(f"{alias}.{path}")
            for name, path in modules.items()}


def event_us(fn, flush=None) -> float:
    """The median of ``EVENT_REPS`` CUDA-event times of ``fn()``, each
    queued behind a device sleep so that the host's launch cost is not in
    the time (as ``chip_smoke.py`` times kernels); ``flush``, a tensor, is
    zeroed before each call to empty the L2 (or, a function, is called)."""
    times = []
    for _ in range(EVENT_REPS):
        if callable(flush):
            flush()
        elif flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def host_us(fn, calls) -> float:
    """Wall time per call of ``fn(*a)`` for ``a`` in ``calls``, in a row."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in calls:
        fn(*a)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(calls) * 1e6
