#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from; the benchmark's
own runs never run this.

    python3 perfbench/control.py --workload tree-exact-q64 \\
        --impl control --seeds 11 12 13 --requests 12

For each seed, in one process: the cell's set-up and ``--requests``
requests at the cell's own sizes, then the same comparison a run makes.
``--impl program`` gives the lower readings (the program's numbers on
sound runs); ``--impl control`` the upper ones (the reference in the
program's place, a precision below the configuration's: TF32 k-NN, a
bfloat16 build).  One JSON line a seed on standard output, with the
counts the run observed beside its numbers.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--impl", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        try:
            r = run.run_cell(args.workload, seed, 0.0, False,
                             impl=args.impl, requests=args.requests,
                             t_start=t0)
        except run.Unavailable as e:
            print(f"perfbench: {e}", file=sys.stderr)
            return 2
        print(json.dumps({"workload": args.workload, "impl": args.impl,
                          "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "seconds": time.perf_counter() - t0,
                          "observed": r["observed"],
                          "checks": r["checks"]}), flush=True)
        del r
        gc.collect()
        import torch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
