#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training phase (20) alone on a CUDA card.

Drives ``launch/train.py``'s ``train`` at ``llama3.2-1b``'s published
width as phase 20 does: (a) 20 AdamW steps of 8 x 1024 tokens in bf16
with remat (tokens/s, seconds a step, model-FLOP share, busy share and
peak memory), (b) SMOKE dense and MoE steps with two microbatches, card
against CPU, (c) the fault-tolerant loop's restart against an
uninterrupted run and a checkpoint round trip, (d) a four-stage GPipe
forward on one card.  No kernel is on the training path, so nothing is
built.  Prints the phase's own lines, its seconds and the card's name and
power limit.  From the repository root::

    python3 tools/chip_train.py
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
        print("chip_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(cs.card_line())
    t0 = time.perf_counter()
    launches = cs.training_phase(torch, np)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")
    print(f"launches: {launches}")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
