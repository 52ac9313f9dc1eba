"""Compare the cross form of ``batch_euclid`` across checkouts on one card.

For each ``repro_torch`` package given by ``--src`` (a checkout's ``src``
directory), loaded under a name of its own so that several trees run in
one process:

* ``bits``: at each shape below, whether the kernel's output equals the
  package's plain twin (``kernels.ref.batch_euclid_ref`` on the CPU) bit
  for bit, or the error with which the kernel refused the shape (such a
  shape is not timed); the run fails on a wrong bit;
* ``kernel_us``: the median of 200 CUDA-event times of one launch, L2
  warm, each launch queued behind a 1 ms device sleep so that the host's
  launch cost is not in the time (as ``chip_smoke.py`` times kernels), at
  Q x N x L = 64 x 1183 x 256 (the densest verify launch), 64 x 175 x
  256 (the eager batch's median launch), 1 x 2000 x 256 (a leaf at
  Q = 1), and 64 x 1183 x 1024 and 64 x 175 x 4096 (L chunked);
* ``host_us``: the wrapper's wall time per call over 200 calls in a row
  at 64 x 175 (``fixed``) and over the row counts of ``--rows`` in order
  (``sequence``: a ``.npy`` that ``chip_smoke.py`` writes from the eager
  batch's cross launches, ``build/eager_cross_rows.npy``); each call's
  kernel is shorter than its host path, so this is the host's time.

Trees alternate A, B, B, A in each of ``--reps`` rounds; each number is
the median over the rounds, and every round's value is printed too.
Prints one JSON line per tree and the card's name.

Run from the root of a checkout:

    python3 tools/compare_cross.py --rows build/eager_cross_rows.npy \\
        --src src path/to/other/checkout/src
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from compare_common import event_us, host_us, load

SHAPES = ((64, 1183, 256), (64, 175, 256), (1, 2000, 256),
          (64, 1183, 1024), (64, 175, 4096))
HOST_Q, HOST_L, FIXED_ROWS, FIXED_CALLS = 64, 256, 175, 200


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", nargs="+", required=True,
                    help="directories that hold a repro_torch package")
    ap.add_argument("--rows", help=".npy of the eager batch's row counts")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    data = {s: (torch.randn(s[0], s[2], device="cuda", generator=gen),
                torch.randn(s[1], s[2], device="cuda", generator=gen))
            for s in SHAPES}
    rows = ([int(r) for r in np.load(args.rows)] if args.rows
            else [FIXED_ROWS])
    q = torch.randn(HOST_Q, HOST_L, device="cuda", generator=gen)
    x = torch.randn(max(rows + [FIXED_ROWS]), HOST_L, device="cuda",
                    generator=gen)
    calls = {"fixed": [(q, x[:FIXED_ROWS])] * FIXED_CALLS,
             "sequence": [(q, x[:r]) for r in rows]}
    trees = [tuple(load(s, f"tree{i}_repro_torch",
                        {"be": "kernels.batch_euclid",
                         "ref": "kernels.ref"}).values())
             for i, s in enumerate(args.src)]
    out = []
    for be, ref in trees:
        bits = {}
        for s, (qs, xs) in data.items():
            try:
                got = be.batch_euclid(qs, xs).cpu()
            except RuntimeError as e:        # a kernel that refuses the shape
                bits[str(s)] = f"refused: {e}"
                # an entry point that returns before its launch may leave
                # CUDA's last error set for its next call to read: absorb it
                try:
                    be.batch_euclid(qs[:1, :32].contiguous(),
                                    xs[:1, :32].contiguous())
                except RuntimeError:
                    pass
                continue
            bits[str(s)] = torch.equal(
                got.view(torch.int32),
                ref.batch_euclid_ref(qs.cpu(), xs.cpu()).view(torch.int32))
        out.append({"bits": bits,
                    "kernel_us": {str(s): [] for s in SHAPES
                                  if bits[str(s)] is True},
                    "host_us": {k: [] for k in calls}})
    order = list(range(len(trees)))
    for _ in range(args.reps):
        for i in order + order[::-1]:
            fn = trees[i][0].batch_euclid
            for s, (qs, xs) in data.items():
                if str(s) in out[i]["kernel_us"]:
                    out[i]["kernel_us"][str(s)].append(
                        event_us(lambda: fn(qs, xs)))
            for k, c in calls.items():
                out[i]["host_us"][k].append(host_us(fn, c))
    print(torch.cuda.get_device_name(0))
    for src, o in zip(args.src, out):
        med = {part: {k: statistics.median(v) for k, v in o[part].items()}
               for part in ("kernel_us", "host_us")}
        print(json.dumps({"src": src, "bits": o["bits"],
                          "sequence_calls": len(rows), "median": med,
                          "rounds": {p: o[p] for p in ("kernel_us",
                                                       "host_us")}}))
    # a refused shape is reported; a wrong bit fails the run
    return 0 if all(b is not False for o in out
                    for b in o["bits"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
