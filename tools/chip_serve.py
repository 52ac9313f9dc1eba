#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s serving phase (19) alone on a CUDA card.

Builds the kernels, holds each of them against its plain twin at the
shapes the serving index gives it (phase 2's serving-shape checks), then
drives ``launch/serve.py``'s loop at ``llama3.2-1b``'s published width as
phase 19 does: (a) batch 64, prompt 256, 128 decode steps into the
streaming index, (b) the last probe micro-batch against brute force, (c)
fp32 prefill + decode against a forward, (d) the sharded mesh store twice
on one directory, a third tiered run at k 10 against brute force, and a
budgeted pass.  Prints each part's seconds (the phase's own lines), the launches,
the device peak and the card's name and power limit.  From the
repository root::

    python3 tools/chip_serve.py
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
        print("chip_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import loader
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    t0 = time.perf_counter()
    loader.build()
    loader.library()
    print(f"build: kernels built in {time.perf_counter() - t0:.1f} s")
    from repro_torch.core import summarization as S
    from repro_torch.kernels import ops, ref
    from repro_torch.storage.packing import pack_codes
    t0 = time.perf_counter()
    err = {}
    cs.serving_shapes(torch, np, S, ops, ref, pack_codes,
                      torch.device("cuda"), np.random.default_rng(cs.SEED),
                      err)
    print(f"kernels at the serving shapes: all equal to their plain twins "
          f"({err}) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = cs.serving_phase(torch, np)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s")
    print(f"launches: {launches}")
    print(f"device peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
          f"(since the phase's weights were drawn)")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
