"""Checkpointing with async save, atomic publish, and restore onto any
device.

Layout, as the reference's: ``<dir>/step_<8 digits>/`` holding
``arrays.npz`` (the state's tensors, keyed by their path in the state,
``/``-joined: ``params/layers.0.attn.wq``, ``opt/m/...``, ``opt/step``) and
``meta.json`` (``step``, ``time``, ``leaves``, and ``dtypes`` for the
tensors numpy cannot hold).  Writes go to ``step_<n>.tmp`` and are renamed
only when complete, so a crash mid-save never corrupts the latest
checkpoint: the fault-tolerance loop (``runtime.py``) restarts from the
newest *published* step.

numpy has no bfloat16: such a tensor is stored as its ``uint16`` bits and
its dtype recorded, so a round trip is bit for bit.  The snapshot to host
memory is synchronous (the next train step updates the state in place);
the write to disk runs on a thread.  ``restore(..., device=)`` puts the
state on another device than the writer's (elastic resume).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager"]

def _paths(tree, prefix: str = ""):
    """(path, tensor) for every tensor of a nested dict, in dict order."""
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _paths(v, key + "/")
        else:
            yield key, v


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """A tensor as a host array, and the dtype to record where numpy has
    none (bfloat16, kept as its uint16 bits)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    return t.cpu().numpy(), None


def _from_host(a: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if dtype_name is not None:
        raise TypeError(f"unknown recorded dtype {dtype_name!r}")
    return torch.from_numpy(np.array(a))


def _rebuild(template, arrays, dtypes, device, prefix: str = ""):
    out = {}
    for k, v in template.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = _rebuild(v, arrays, dtypes, device, key + "/")
            continue
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = _from_host(arrays[key], dtypes.get(key))
        out[k] = t.to(device=device if device is not None else v.device,
                      dtype=v.dtype)
    return out


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.save_count = 0

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, *, blocking: bool = False) -> None:
        # snapshot to host *synchronously* (the next train step updates
        # the state's tensors in place), write to disk asynchronously
        flat: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}
        for key, t in _paths(state):
            flat[key], name = _to_host(t)
            if name is not None:
                dtypes[key] = name
        meta = {"step": int(step), "time": time.time(),
                "leaves": sorted(flat), "dtypes": dtypes}
        if self.async_save and not blocking:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, meta)

    def _write(self, step: int, flat, meta) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish
        self.save_count += 1
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp") \
                    and (p / "meta.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, device=None):
        """A new state with ``template``'s structure and dtypes, read from
        ``step`` (the newest published one by default), on ``device`` (by
        default each tensor on its template tensor's device).  Returns
        (state, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / "arrays.npz") as z:
            arrays = dict(z)
        state = _rebuild(template, arrays, meta.get("dtypes", {}), device)
        return state, step
