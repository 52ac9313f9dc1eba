#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s static sharded and ``obs`` phases alone on a
CUDA card.

Phases 17 (the static sharded tree over phase 3's walks) and 18 (``obs``:
profiled launches, capture, a live sharded engine's query log and the
HTTP scrape) compare their answers with phase 4's eager batch on phase
3's tree, so this builds the kernels, makes phase 3's walks, queries and
tree from the same seed, runs the eager batch twice (the second one
timed), then phases 17 and 18, and prints each phase's seconds, the
launches, the device peak and the card's name and power limit.  From the
repository root::

    python3 tools/chip_static.py
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
        print("chip_static: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.core import tree as T
    from repro_torch.data import series
    from repro_torch.kernels import loader
    loader.build()
    loader.library()
    print(cs.card_line())
    dev = torch.device(cs.DEVICE)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x = cs.make_data(torch, series, gen, cs.N_ROWS, INDEX.series_len)
    queries = series.query_workload(gen, x, cs.N_QUERIES)
    tree = T.build(x, INDEX, leaf_size=LEAF_SIZE)
    e_d, e_o, _ = T.exact_search_batch(tree, queries, k=cs.K)
    t0 = time.perf_counter()
    T.exact_search_batch(tree, queries, k=cs.K)
    eager_s = time.perf_counter() - t0
    print(f"phase 4: eager batch {eager_s:.3f} s warm")
    t0 = time.perf_counter()
    static = cs.static_sharded_phase(torch, np, x, queries, (e_d, e_o))
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    obs = cs.obs_phase(torch, np, x, tree, queries, (e_d, e_o), eager_s)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")
    print(f"launches: phase 17 {static}; phase 18 {obs}")
    print(f"device peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
          f"(since phase 17's build)")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
