#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s pod-tooling phase (21) alone on a CUDA card,
or the dry run's sweep of whole columns on the card host's CPU.

(a) Phase 20's train step (``llama3.2-1b`` at its published width in
bf16, 8 x 1024 tokens, remat) over a ``(1, 1)`` and a ``(1, 1, 1)``
DeviceMesh on a one-rank NCCL group, ``shard_state`` + ``sh``, against
the same steps unsharded: bit for bit, seconds a step, busy share, the
peak memory's rise; (b) the dry run's reckoning of that cell on a fake
one-rank world: argument bytes exact, peak within 25% of the rise; (c)
the production cell ``llama3.2-1b`` x ``train_4k`` x single through the
dry run's command line.  No kernel is on this path, so nothing is built.
Prints the phase's own lines and the card's name and power limit.  From
the repository root::

    python3 tools/chip_dryrun.py

``--sweep`` runs no phase: it traces every arch's ``train_4k`` and
``prefill_32k`` cells on both pod meshes, a ``python -m
repro_torch.launch.dryrun`` process a cell, ``--jobs`` at once, the
biggest archs first, from the tree ``--src`` (default this checkout's;
another tree's ``src`` unpacked under ``build/`` traces that tree), and
prints each cell's peak GiB a device, dominant term, collective ms and
trace seconds, single beside multi, with multi over single; ``--out``
also writes the records (memory, roofline, timings)::

    python3 tools/chip_dryrun.py --sweep --jobs 8 --out build/sweep.json
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the biggest first, so the longest cells start first
SWEEP_ARCHS = ("llama3-405b", "llama4-maverick-400b-a17b", "qwen1.5-110b",
               "mamba2-2.7b", "granite-moe-1b-a400m", "recurrentgemma-2b",
               "seamless-m4t-medium", "phi-3-vision-4.2b", "granite-3-2b",
               "llama3.2-1b")
SWEEP_SHAPES = ("train_4k", "prefill_32k")
CELL_S = 1800                   # one cell's time limit


def phase() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_dryrun: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(cs.card_line())
    t0 = time.perf_counter()
    cs.pod_phase(torch, np)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")
    print(cs.card_line())
    return 0


def _cell(src: Path, arch: str, shape: str, mesh: str) -> dict:
    """One cell through the dry run's command line; its JSON record."""
    env = dict(os.environ, PYTHONPATH=str(src))
    path = src.parent / "build" / "dryrun" / f"{arch}_{shape}_{mesh}.json"
    path.unlink(missing_ok=True)
    t = time.perf_counter()
    try:
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh], env=env,
            capture_output=True, text=True, timeout=CELL_S)
        rc, err = p.returncode, p.stderr
    except subprocess.TimeoutExpired:
        rc, err = None, f"no end in {CELL_S} s"
    wall = time.perf_counter() - t
    rec = json.loads(path.read_text()) if path.exists() else {
        "status": "failed", "error": err[-2000:]}
    rec["wall_s"] = wall
    if rc != 0 and rec.get("status") == "ok":
        rec["status"] = "failed"
    return rec


def _brief(rec: dict) -> str:
    if rec.get("status") != "ok":
        return rec.get("status", "?")
    m, r = rec["memory"], rec["roofline"]
    return (f"{m['peak_memory_in_bytes'] / 2**30:.2f} GiB "
            f"{r['dominant']}, coll {r['collective_s'] * 1e3:.1f} ms, "
            f"trace {rec['timings']['trace_s']:.1f} s")


def sweep(src: Path, jobs: int, out) -> int:
    import torch
    archs, shapes = SWEEP_ARCHS, SWEEP_SHAPES
    print(f"dry-run sweep of {' '.join(shapes)} from {src}, torch "
          f"{torch.__version__}, {jobs} processes")
    cells = [(a, s, m) for a in archs for s in shapes
             for m in ("single", "multi")]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(jobs) as pool:
        recs = dict(zip(cells, pool.map(lambda c: _cell(src, *c), cells)))
    failed = 0
    for a in archs:
        for s in shapes:
            one, two = recs[(a, s, "single")], recs[(a, s, "multi")]
            ratio = ""
            if one.get("status") == two.get("status") == "ok":
                peaks = [r["memory"]["peak_memory_in_bytes"]
                         for r in (one, two)]
                ratio = f"; multi / single {peaks[1] / peaks[0]:.3f}"
            failed += sum(r.get("status") == "failed" for r in (one, two))
            print(f"{a} x {s}: single {_brief(one)} | multi "
                  f"{_brief(two)}{ratio}")
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps({f"{a}|{s}|{m}": {
            k: r.get(k) for k in ("status", "memory", "roofline",
                                  "timings", "wall_s", "error")}
            for (a, s, m), r in recs.items()}, indent=1))
    print(f"sweep: {len(cells)} cells, {failed} failed, "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="also write every cell's record here (JSON)")
    args = ap.parse_args(argv)
    if args.sweep:
        return sweep(Path(args.src).resolve(), args.jobs, args.out)
    return phase()


if __name__ == "__main__":
    sys.exit(main())
