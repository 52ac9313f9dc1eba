"""Fault-tolerant training runtime: checkpoint/restart, straggler watch,
elastic resume.

The loop is deliberately plain: a team could read it in one sitting.

  * **checkpoint/restart**: periodic async checkpoints; on any step
    exception the loop restores the newest published checkpoint and
    continues (``max_restarts`` bounds a crash loop).  Fault injection for
    tests via ``fault_hook``.
  * **straggler mitigation**: per-step deadline tracking; steps slower
    than ``straggler_factor`` x the rolling median are counted.
  * **elastic resume**: ``CheckpointManager.restore`` puts the state on
    another device than the writer's (``state_device``).

A step's time runs to the read-back of its loss, which waits for the
device: that read-back is the step's synchronization point.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from .checkpoint import CheckpointManager

__all__ = ["RuntimeConfig", "TrainRuntime"]


@dataclasses.dataclass
class RuntimeConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    keep_checkpoints: int = 3
    max_restarts: int = 5
    straggler_factor: float = 3.0
    log_every: int = 10
    metrics_path: Optional[str] = None


class TrainRuntime:
    def __init__(self, train_step: Callable, state, data_iter_fn: Callable,
                 ckpt_dir, cfg: RuntimeConfig,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 state_device=None):
        """``data_iter_fn(step) -> batch`` must be stateless/resumable:
        the restart path re-seeks the pipeline to the restored step."""
        self.train_step = train_step
        self.state = state
        self.data_iter_fn = data_iter_fn
        self.cfg = cfg
        self.ckpt = CheckpointManager(ckpt_dir, keep=cfg.keep_checkpoints)
        self.fault_hook = fault_hook
        self.state_device = state_device
        self.step = 0
        self.restarts = 0
        self.stragglers = 0
        self._durations: list = []
        self.metrics_log: list = []

    @property
    def durations(self) -> list:
        """Every step's seconds so far, each to its loss read-back."""
        return list(self._durations)

    # ---------------------------------------------------------------- resume
    def try_resume(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        self.state, self.step = self.ckpt.restore(
            self.state, device=self.state_device)
        return True

    # ------------------------------------------------------------------ run
    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        while self.step < cfg.total_steps:
            try:
                self._run_span()
            except Exception as e:  # noqa: BLE001: restart-from-checkpoint
                self.restarts += 1
                if self.restarts > cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={cfg.max_restarts}") from e
                self.ckpt.wait()
                if not self.try_resume():
                    # no checkpoint yet: restart from the initial state
                    self.step = 0
        self.ckpt.wait()
        return {
            "final_step": self.step,
            "restarts": self.restarts,
            "stragglers": self.stragglers,
            "checkpoints": self.ckpt.save_count,
        }

    def _run_span(self) -> None:
        cfg = self.cfg
        while self.step < cfg.total_steps:
            if self.fault_hook is not None:
                self.fault_hook(self.step)        # may raise (fault inject)
            batch = self.data_iter_fn(self.step)
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            loss = float(metrics["loss"])         # waits for the device
            dt = time.perf_counter() - t0
            self._watch_straggler(dt)
            self.step += 1
            if self.step % cfg.log_every == 0 or self.step == 1:
                rec = {"step": self.step, "loss": loss,
                       "grad_norm": float(metrics.get("grad_norm", 0.0)),
                       "sec": dt}
                self.metrics_log.append(rec)
                if cfg.metrics_path:
                    with open(cfg.metrics_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
            if self.step % cfg.checkpoint_every == 0:
                self.ckpt.save(self.step, self.state)

    def _watch_straggler(self, dt: float) -> None:
        self._durations.append(dt)
        hist = self._durations[-50:]
        if len(hist) >= 5:
            med = float(np.median(hist))
            if dt > self.cfg.straggler_factor * med:
                self.stragglers += 1
