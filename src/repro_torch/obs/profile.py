"""Profiling hooks: optional ``torch.profiler`` ranges around kernel
launches, with a wall-clock mode that works everywhere.

Off by default — the kernel dispatchers (``kernels/ops.py``) are wrapped
in :func:`profiled`, which costs one global check per launch until
profiling is enabled by flag (:func:`enable_profiling`) or environment::

    COCONUT_PROFILE=wall   # wall-clock: synchronize the device before and
                           # after the launch, record a kernel.<name>_ms
                           # histogram + trace span
    COCONUT_PROFILE=torch  # same, plus torch.profiler.record_function
                           # ("coconut.<name>") so the launch shows up
                           # named in a torch.profiler trace
    COCONUT_PROFILE_DIR=/x # where capture() writes its Chrome trace

Wall-clock mode deliberately synchronizes: CUDA launches are
asynchronous, so an unsynchronized timer measures the enqueue, not the
kernel.  That makes profiling *observationally intrusive* (it
serializes the host and the card) — which is why it is gated and never
on in production serving.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import time
from typing import Optional

import torch

from .registry import get_registry
from .trace import get_tracer

__all__ = ["profiled", "enable_profiling", "disable_profiling",
           "profiling_mode", "capture"]

_MODES = ("", "wall", "torch")
_CAPTURES = itertools.count()


def _env_mode() -> str:
    v = os.environ.get("COCONUT_PROFILE", "").strip().lower()
    if v in ("1", "true", "wall"):
        return "wall"
    if v == "torch":
        return "torch"
    return ""


_mode = _env_mode()


def enable_profiling(mode: str = "wall") -> None:
    if mode not in _MODES[1:]:
        raise ValueError(f"profiling mode must be one of {_MODES[1:]}, "
                         f"got {mode!r}")
    global _mode
    _mode = mode


def disable_profiling() -> None:
    global _mode
    _mode = ""


def profiling_mode() -> str:
    """Current mode: '' (off), 'wall', or 'torch'."""
    return _mode


def _identity(x):
    return x


def _sync_all() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _synced(out):
    """``out`` once the devices of its tensors have finished."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for dev in {t.device for t in items if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out


class profiled:
    """Instrument one kernel launch, as a context manager or a decorator.

    ``with profiled(name) as done: return done(launch(...))`` — ``done``
    is a passthrough when profiling is off; with profiling on, the
    device is synchronized before the launch and ``done`` synchronizes
    the devices of the output, so the recorded wall time covers the
    device work; then ``kernel.<name>_ms`` is observed and a trace span
    emitted.  ``@profiled(name)`` on a dispatcher does the same around
    each call, and costs one global check per call when off.
    """

    __slots__ = ("name", "_stack")

    def __init__(self, name: str):
        self.name = name
        self._stack = None

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def launch(*args, **kwargs):
            if not _mode:
                return fn(*args, **kwargs)
            with profiled(name) as done:
                return done(fn(*args, **kwargs))
        return launch

    def __enter__(self):
        if not _mode:
            return _identity
        stack = contextlib.ExitStack()
        if _mode == "torch":
            stack.enter_context(
                torch.profiler.record_function(f"coconut.{self.name}"))
        sp = stack.enter_context(get_tracer().span(f"kernel.{self.name}"))
        _sync_all()
        t0 = time.perf_counter()

        def observe():
            dt_ms = (time.perf_counter() - t0) * 1e3
            sp.set(wall_ms=dt_ms)
            get_registry().histogram(f"kernel.{self.name}_ms").observe(dt_ms)

        # on exit, whether or not the launch raised: the observation, then
        # the span, then the range (the reverse of their registration)
        stack.callback(observe)
        self._stack = stack
        return _synced

    def __exit__(self, *exc) -> bool:
        stack, self._stack = self._stack, None
        if stack is not None:
            stack.__exit__(*exc)
        return False


@contextlib.contextmanager
def capture(logdir: Optional[str] = None):
    """Whole-region ``torch.profiler`` capture, written as a Chrome trace
    (``capture-<pid>-<n>.json``) under ``logdir`` or
    ``COCONUT_PROFILE_DIR`` when either is given; otherwise a plain
    wall-clock region.  Either way the region's wall time is recorded as
    ``profile.capture_ms``.  A profiler that cannot start or write is
    skipped, never raised: observability must not take down serving."""
    logdir = logdir or os.environ.get("COCONUT_PROFILE_DIR")
    prof = None
    if logdir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        except RuntimeError:                  # pragma: no cover
            prof = None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        get_registry().histogram("profile.capture_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    logdir, f"capture-{os.getpid()}-{next(_CAPTURES)}.json"))
            except (RuntimeError, OSError):   # pragma: no cover
                pass
