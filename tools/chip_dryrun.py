#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s pod-tooling phase (21) alone on a CUDA card.

(a) Phase 20's train step (``llama3.2-1b`` at its published width in
bf16, 8 x 1024 tokens, remat) over a ``(1, 1)`` DeviceMesh on a one-rank
NCCL group, ``shard_state`` + ``sh``, against the same steps unsharded:
bit for bit, seconds a step, busy share, the peak memory's rise; (b) the
dry run's reckoning of that cell on a fake one-rank world: argument bytes
exact, peak within 25% of the rise; (c) the production cell
``llama3.2-1b`` x ``train_4k`` x single through the dry run's command
line.  No kernel is on this path, so nothing is built.  Prints the
phase's own lines and the card's name and power limit.  From the
repository root::

    python3 tools/chip_dryrun.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
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


if __name__ == "__main__":
    sys.exit(main())
