#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s sharded phases alone on a CUDA card.

Phases 15 (the sharded engine, threaded and mesh, and a rebalance) and 16
(the sharded store: reopen, tiers, a concurrent engine) compare their
answers with phases 10 and 11, so this builds the kernels, makes phase
3's walks and queries from the same seed, runs phases 10 and 11, then 15
and 16, and prints each phase's seconds, the launches and the card's
name and power limit.  It skips phase 3's tree, so its device memory
differs from the whole script's.  From the repository root::

    python3 tools/chip_sharded.py
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
        print("chip_sharded: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import INDEX
    from repro_torch.data import series
    from repro_torch.kernels import loader
    loader.build()
    loader.library()
    dev = torch.device(cs.DEVICE)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x = cs.make_data(torch, series, gen, cs.N_ROWS, INDEX.series_len)
    queries = series.query_workload(gen, x, cs.N_QUERIES)
    t0 = time.perf_counter()
    _, stream = cs.streaming_phase(torch, np, x, queries)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, modes = cs.modes_phase(torch, np, x, queries)
    torch.cuda.empty_cache()
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded, _ = cs.sharded_phase(torch, np, x, queries, stream)
    torch.cuda.empty_cache()
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    store = cs.sharded_store_phase(torch, np, x, queries, modes)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    print(f"launches: phase 15 {sharded}; phase 16 {store}")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
