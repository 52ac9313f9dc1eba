"""Compare the bound kernels (``mindist_batch``, ``unpack_mindist``) across
checkouts on one card.

For each ``repro_torch`` package given by ``--src`` (a checkout's ``src``
directory), loaded under a name of its own so that several trees run in
one process:

* ``bits``: at each shape below, whether each kernel's output equals the
  package's plain twin (``kernels.ref`` on the CPU) bit for bit, or the
  error with which the kernel refused the shape (such a shape is not
  timed); the run fails on a wrong bit;
* ``kernel_us``: the median of 200 CUDA-event times of one launch, each
  queued behind a 1 ms device sleep so that the host's launch cost is not
  in the time (as ``chip_smoke.py`` times kernels), L2 warm, at Q x N x w
  = 64 x 2000 x 16 (one leaf of the main path), 64 x 175 x 16, 1 x 2000 x
  16 (``ops.mindist``) and 64 x 2000 x 64 (or the ``--shapes`` given), for
  ``mindist_batch`` on codes and ``unpack_mindist`` on their packed rows
  at b = 8, and at the first shape also ``unpack_mindist`` with the L2
  flushed before each launch (a hot-tier block) and at b = 4 (staged
  packed rows);
* ``floor_us``: the same timing of a one-element ``fill_``, the least
  that a launch reads by this method;
* ``host_us``: each wrapper's wall time per call over 200 calls in a row
  at the first shape (the kernel is shorter than the host path, so this
  is the host's time).

Trees alternate A, B, B, A in each of ``--reps`` rounds; each number is
the median over the rounds, and every round's value is printed too.
``--qt 1 2 4`` also times the first tree's kernels with each of those
query tiles in place of its plan's own, at the same shapes (for judging
the plan's choice of tile).  Prints one JSON line per tree (and per
tile) and the card's name.

Run from the root of a checkout:

    python3 tools/compare_mindist.py --src src path/to/other/checkout/src
    python3 tools/compare_mindist.py --src src --qt 1 2 4 \
        --shapes 2,2000,16 4,2000,16 8,2000,16 16,2000,16
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from compare_common import event_us, host_us, load

SHAPES = ((64, 2000, 16), (64, 175, 16), (1, 2000, 16), (64, 2000, 64))
HOST_CALLS, FLUSH_BYTES = 200, 256 << 20
MODULES = {"mb": "kernels.mindist_batch", "um": "kernels.unpack_mindist",
           "ref": "kernels.ref", "S": "core.summarization",
           "pack": "storage.packing"}


def cases(t: dict, data: dict, first: tuple) -> dict:
    """(kernel call, plain twin on the CPU, L2 flushed) per case name."""
    mb, um, ref = t["mb"].mindist_batch, t["um"].unpack_mindist, t["ref"]
    out = {}
    for s, d in data.items():
        nq, n, w = s
        q, c, pk, tabs = d["q"], d["codes"], d["packed"], d["tables"]
        lo, hi = tabs[8]
        scale = 256 / w
        cpu = [x.cpu() for x in (q, c, lo, hi)]
        out[f"mindist_batch {s}"] = (
            lambda q=q, c=c, lo=lo, hi=hi, scale=scale: mb(q, c, lo, hi, scale),
            lambda cpu=cpu, scale=scale: ref.mindist_batch_ref(*cpu, scale),
            False)
        out[f"unpack_mindist b=8 {s}"] = (
            lambda q=q, p=pk[8], lo=lo, hi=hi, scale=scale, w=w:
                um(q, p, lo, hi, scale, w=w, b=8),
            lambda cpu=cpu, scale=scale: ref.mindist_batch_ref(*cpu, scale),
            False)
        if s == first:
            out[f"unpack_mindist b=8 L2 cold {s}"] = (
                out[f"unpack_mindist b=8 {s}"][0],
                out[f"unpack_mindist b=8 {s}"][1], True)
            lo4, hi4 = tabs[4]
            c4 = d["codes4"].cpu()
            out[f"unpack_mindist b=4 {s}"] = (
                lambda q=q, p=pk[4], lo=lo4, hi=hi4, scale=scale, w=w:
                    um(q, p, lo, hi, scale, w=w, b=4),
                lambda q=q.cpu(), c=c4, lo=lo4.cpu(), hi=hi4.cpu(),
                scale=scale: ref.mindist_batch_ref(q, c, lo, hi, scale),
                False)
    return out


def with_qt(t: dict, qt: int) -> None:
    """Make the tree's wrappers launch ``qt`` queries a block."""
    mbm = t["mb"]
    own = mbm.launch_plan.__wrapped__

    def plan(nq, n, w):
        p = own(nq, n, w)
        return p._replace(qt=qt, grid=(p.grid[0], -(-nq // qt)))
    mbm.launch_plan = plan
    t["um"].launch_plan = plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", nargs="+", required=True,
                    help="directories that hold a repro_torch package")
    ap.add_argument("--shapes", nargs="*", default=[],
                    help="Q,N,w shapes in place of the default ones")
    ap.add_argument("--qt", nargs="*", type=int, default=[],
                    help="query tiles to time on the first tree")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    shapes = ([tuple(int(v) for v in x.split(",")) for x in args.shapes]
              or SHAPES)
    first = shapes[0]
    trees = [load(s, f"tree{i}_repro_torch", MODULES)
             for i, s in enumerate(args.src)]
    S, pack = trees[0]["S"], trees[0]["pack"]
    rng = np.random.default_rng(args.seed)
    tables = {b: tuple(x.cuda() for x in S.region_bounds(b)) for b in (4, 8)}
    data = {}
    for s in shapes:
        nq, n, w = s
        codes = rng.integers(0, 256, (n, w), dtype=np.uint8)
        codes4 = codes >> 4
        data[s] = {
            "q": torch.from_numpy(
                rng.standard_normal((nq, w)).astype(np.float32)).cuda(),
            "codes": torch.from_numpy(codes).cuda(),
            "codes4": torch.from_numpy(codes4).cuda(),
            "packed": {8: torch.from_numpy(pack.pack_codes(codes, 8)).cuda(),
                       4: torch.from_numpy(pack.pack_codes(codes4, 4)).cuda()},
            "tables": tables}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    one = torch.empty(1, device="cuda")
    floor = []
    runs = [(src, t) for src, t in zip(args.src, trees)]
    for qt in args.qt:
        t = load(args.src[0], f"qt{len(runs)}_repro_torch", MODULES)
        with_qt(t, qt)
        runs.append((f"{args.src[0]} qt {qt}", t))
    out = []
    for _, t in runs:
        cs = cases(t, data, first)
        bits = {}
        for name, (fn, twin, _) in cs.items():
            try:
                got = fn().cpu()
            except RuntimeError as e:        # a kernel that refuses the shape
                bits[name] = f"refused: {e}"
                continue
            bits[name] = torch.equal(got.view(torch.int32),
                                     twin().view(torch.int32))
        out.append({"cases": cs, "bits": bits,
                    "kernel_us": {k: [] for k in cs if bits[k] is True},
                    "host_us": {k: [] for k in ("mindist_batch",
                                                "unpack_mindist")}})
    order = list(range(len(runs)))
    q, c, pk = (data[first][k] for k in ("q", "codes", "packed"))
    host_calls = [()] * HOST_CALLS
    w = first[2]
    lo, hi = tables[8]
    for _ in range(args.reps):
        floor.append(event_us(lambda: one.fill_(0.0)))
        for i in order + order[::-1]:
            o, t = out[i], runs[i][1]
            for name in o["kernel_us"]:
                fn, _, cold = o["cases"][name]
                o["kernel_us"][name].append(
                    event_us(fn, flush if cold else None))
            o["host_us"]["mindist_batch"].append(host_us(
                lambda: t["mb"].mindist_batch(q, c, lo, hi, 16.0),
                host_calls))
            o["host_us"]["unpack_mindist"].append(host_us(
                lambda: t["um"].unpack_mindist(q, pk[8], lo, hi, 16.0, w=w,
                                               b=8), host_calls))
    print(torch.cuda.get_device_name(0))
    print(json.dumps({"floor_us": statistics.median(floor), "rounds": floor}))
    for (src, _), o in zip(runs, out):
        med = {part: {k: statistics.median(v) for k, v in o[part].items()}
               for part in ("kernel_us", "host_us")}
        print(json.dumps({"src": src, "bits": o["bits"], "median": med,
                          "rounds": {p: o[p] for p in ("kernel_us",
                                                       "host_us")}}))
    # a refused shape is reported; a wrong bit fails the run
    return 0 if all(b is not False for o in out
                    for b in o["bits"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
