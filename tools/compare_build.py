"""Compare the build kernels (``sax_summarize``, ``fused_build``, ``zorder``)
across checkouts on one card.

For each ``repro_torch`` package given by ``--src`` (a checkout's ``src``
directory), loaded under a name of its own so that several trees run in
one process:

* ``bits``: at each shape below, whether each kernel's outputs equal the
  package's plain twin (``kernels.ref``, run on the same CUDA tensors) bit
  for bit, and ``fused_build``'s equal ``sax_summarize``'s (and, at
  w <= 64, its keys ``zorder``'s of those codes); the run fails on a wrong
  bit;
* ``kernel_us``: the median of 200 CUDA-event times of one launch, each
  queued behind a 1 ms device sleep so that the host's launch cost is not
  in the time, with the L2 flushed before each launch by zeroing 256 MiB
  (as ``chip_smoke.py`` times kernels): ``sax_summarize`` at 65,536 x 256
  (one external-sort chunk), ``fused_build`` at 8,388,608 x 256 (the tree
  build) and 1,048,576 x 256, and both kernels at 1,048,576 rows of
  (L, w) = (64, 8) and (300, 12) (a shape of the generic tile); and
  ``sax_summarize`` at 65,536 x 256 with the L2 flushed by reading the
  256 MiB instead ("read flush": the zeroing leaves 50 MB of dirty lines
  in the L2, whose write-back then shares the kernel's time); ``zorder``
  (random codes made on the card, b = 8) at 65,536 x 16 (one chunk: L2
  flushed by zeroing, by a read, and warm, as pass 1 finds the codes
  ``sax_summarize`` just wrote), at 8,388,608 x 16 (the tree's rows) and
  at 1,048,576 rows of w = 8, 12 and 64;
* ``bound_us``: each case's least time, its bytes (inputs read once,
  outputs written once) over 3.35 TB/s;
* ``floor_us``: the same timing of a one-element ``fill_``, the least
  that a launch reads by this method.

Trees alternate A, B, B, A in each of ``--reps`` rounds; each number is
the median over the rounds, and every round's value is printed too.
``--grids 132 264`` also times the first tree with each of those grids in
place of its plans' own.  ``--only zorder fused_build`` times only the cases whose
names hold one of the words.  ``--sass DIR`` writes each tree's SASS
listing of the three kernels to ``DIR`` (``cuobjdump -sass`` of its built
library) and prints, for each kernel, its instruction count, its local
memory loads and stores, and each loop (a backward branch): its
instructions and their kinds.  Prints one JSON line per run and the card's
name.

Run from the root of a checkout:

    python3 tools/compare_build.py --src src path/to/other/checkout/src
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from compare_common import event_us, load

HBM_BYTES_PER_S = 3.35e12
FLUSH_BYTES = 256 << 20
MODULES = {"sx": "kernels.sax_summarize", "fb": "kernels.fused_build",
           "zo": "kernels.zorder", "ref": "kernels.ref",
           "S": "core.summarization", "keys": "core.keys",
           "loader": "kernels.loader"}
# (kernel, N, L, w, how the L2 is flushed); b = 8 throughout; zorder's
# input is codes, L = 0
CASES = (("sax_summarize", 65_536, 256, 16, "zero"),
         ("fused_build", 8_388_608, 256, 16, "zero"),
         ("fused_build", 1_048_576, 256, 16, "zero"),
         ("sax_summarize", 1_048_576, 64, 8, "zero"),
         ("fused_build", 1_048_576, 64, 8, "zero"),
         ("sax_summarize", 1_048_576, 300, 12, "zero"),
         ("fused_build", 1_048_576, 300, 12, "zero"),
         ("sax_summarize", 65_536, 256, 16, "read"),
         ("zorder", 65_536, 0, 16, "zero"),
         ("zorder", 65_536, 0, 16, "read"),
         ("zorder", 65_536, 0, 16, "warm"),
         ("zorder", 8_388_608, 0, 16, "zero"),
         ("zorder", 1_048_576, 0, 8, "zero"),
         ("zorder", 1_048_576, 0, 12, "zero"),
         ("zorder", 1_048_576, 0, 64, "zero"))
BITS = 8
SASS_KINDS = ("LDG", "LDGSTS", "LDS", "STS", "STG", "LDL", "STL", "FADD",
              "MUFU", "I2F", "F2I", "IMAD", "IADD3", "LOP3", "SHF", "SEL",
              "PRMT", "VOTE", "BREV", "BAR", "CALL", "BRA", "ISETP", "FSETP")


def walks(n: int, L: int, gen: torch.Generator) -> torch.Tensor:
    """z-normalized random walks made on the card."""
    x = torch.randn((n, L), generator=gen, device="cuda").cumsum_(1)
    x -= x.mean(1, keepdim=True)
    x /= x.std(1, keepdim=True) + 1e-8
    return x


def bound_us(kernel: str, n: int, L: int, w: int, nw: int) -> float:
    if kernel == "zorder":
        return n * (w + 8 * nw) / HBM_BYTES_PER_S * 1e6
    out = 5 * w + (8 * nw if kernel == "fused_build" else 0)
    return (n * (4 * L + out) + ((1 << BITS) - 1) * 4) / HBM_BYTES_PER_S * 1e6


def calls(t: dict, data: dict) -> dict:
    """(kernel call, kernel, N, L, w, flush) per case name."""
    sx, fb, zo, S = (t["sx"].sax_summarize, t["fb"].fused_build,
                     t["zo"].zorder, t["S"])
    out = {}
    for kernel, n, L, w, how in CASES:
        x = data[(n, L) if L else ("codes", n, w)]
        bps = S.breakpoints(BITS, device=x.device)
        if kernel == "zorder":
            fn = lambda c=x, w=w: zo(c, w=w, b=BITS)    # noqa: E731
        elif kernel == "sax_summarize":
            fn = (lambda x=x, bps=bps, w=w:
                  sx(x, bps, segments=w, bits=BITS))
        else:
            fn = (lambda x=x, bps=bps, w=w:
                  fb(x, bps, segments=w, bits=BITS))
        name = f"{kernel} {n}x{L or w} w={w}" + {
            "zero": "", "read": " read flush", "warm": " warm"}[how]
        out[name] = (fn, kernel, n, L, w, how)
    return out


def same_bits(t: dict, data: dict) -> dict:
    """Both kernels against the twin and each other at every shape."""
    sx, fb, zo, ref, S = (t[k] for k in ("sx", "fb", "zo", "ref", "S"))
    ok = {}
    for key, x in data.items():
        if key[0] == "codes":             # zorder against its twin
            _, n, w = key
            want = torch.cat([ref.zorder_ref(x[s:s + (1 << 20)], w=w, b=BITS)
                              for s in range(0, n, 1 << 20)])
            ok[f"zorder {n}x{w}"] = bool(torch.equal(
                zo.zorder(x, w=w, b=BITS), want))
            del want
            continue
        n, L = key
        for w in sorted({c[3] for c in CASES if c[1:3] == (n, L)}):
            bps = S.breakpoints(BITS, device=x.device)
            paa, codes = sx.sax_summarize(x, bps, segments=w, bits=BITS)
            f = fb.fused_build(x, bps, segments=w, bits=BITS)
            # the twin in slices: its [rows, L] temporaries stay small
            good = True
            for s in range(0, n, 1 << 20):
                r = ref.fused_build_ref(x[s:s + (1 << 20)], bps, segments=w,
                                        bits=BITS)
                for g, want in zip((paa, codes, *f), (*r[:2], *r)):
                    g = g[s:s + (1 << 20)]
                    if g.dtype == torch.float32:
                        g, want = g.view(torch.int32), want.view(torch.int32)
                    good = good and torch.equal(g, want)
            if w <= 64:
                good = good and torch.equal(
                    zo.zorder(codes, w=w, b=BITS), f[2])
            ok[f"{n}x{L} w={w}"] = bool(good)
            del paa, codes, f
    return ok


def sass(t: dict, tag: str, out_dir: Path) -> dict:
    """The two kernels' SASS from the tree's library: the listing written
    to out_dir, and per kernel its instruction count and loops."""
    lib = t["loader"].build()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    keep = {k: v for k, v in funcs.items()
            if re.search(r"sax_summarize|fused_build|SaxSummarize|"
                         r"FusedBuild|summarize|zorder", k)}
    out_dir.mkdir(parents=True, exist_ok=True)
    summary = {}
    with open(out_dir / f"sass_{tag}.txt", "w") as f:
        for name, ins in keep.items():
            f.write(f"Function : {name}\n")
            for addr, op in ins:
                f.write(f"  /*{addr:04x}*/ {op}\n")
            loops = []
            for addr, op in ins:
                m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
                if m and int(m.group(1), 16) <= addr:
                    lo = int(m.group(1), 16)
                    body = [o for a, o in ins if lo <= a <= addr]
                    kinds = collections.Counter()
                    for o in body:
                        opc = re.sub(r"^@!?U?P\w+\s+", "", o).split()[0]
                        base = opc.split(".")[0]
                        if base in SASS_KINDS:
                            kinds[base] += 1
                    loops.append({"from": f"{lo:04x}", "to": f"{addr:04x}",
                                  "instructions": len(body),
                                  "kinds": dict(kinds)})
            local = sum(1 for _, op in ins if re.search(r"\b(LDL|STL)\b", op))
            summary[name] = {"instructions": len(ins), "local_memory": local,
                             "loops": loops}
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", nargs="+", required=True,
                    help="directories that hold a repro_torch package")
    ap.add_argument("--grids", nargs="*", type=int, default=[],
                    help="grids to time the first tree with")
    ap.add_argument("--only", nargs="*", default=[],
                    help="time only the cases whose names hold a word")
    ap.add_argument("--sass", default=None,
                    help="write SASS listings here and print loop counts")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    trees = [load(s, f"tree{i}_repro_torch", MODULES)
             for i, s in enumerate(args.src)]
    if args.sass:
        for i, (src, t) in enumerate(zip(args.src, trees)):
            print(json.dumps({"src": src, "sass": sass(t, str(i),
                                                       Path(args.sass))}))
    global CASES
    if args.only:
        CASES = tuple(c for c in CASES
                      if any(o in f"{c[0]} {c[1]}x{c[2] or c[3]} w={c[3]}"
                             for o in args.only))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    data = {(n, L): walks(n, L, gen)
            for n, L in sorted({c[1:3] for c in CASES if c[2]})}
    for n, w in sorted({(c[1], c[3]) for c in CASES if not c[2]}):
        data[("codes", n, w)] = torch.randint(
            0, 1 << BITS, (n, w), generator=gen, device="cuda",
            dtype=torch.uint8)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flushes = {"zero": flush, "read": lambda: flush.max(), "warm": None}
    one = torch.empty(1, device="cuda")

    # a run: a tree, and the plan fields given in place of its own
    runs = [(src, t, {}) for src, t in zip(args.src, trees)]
    runs += [(f"{args.src[0]} grid {g}", trees[0], {"grid": g})
             for g in args.grids]

    def enter(t, fields):
        """Give the tree's plans the fields; returns its own plans."""
        own = (getattr(t["sx"], "launch_plan", None),
               getattr(t["zo"], "launch_plan", None))
        if "grid" in fields:
            def plan(n, w, own=own[0]):
                return own(n, w)._replace(grid=fields["grid"])
            t["sx"].launch_plan = t["fb"].launch_plan = plan
        if own[1] is not None and "grid" in fields:
            def zplan(n, w, own=own[1]):
                p = own(n, w)
                return p._replace(grid=min(fields["grid"], -(-n // p.rows)))
            t["zo"].launch_plan = zplan
        return own

    def leave(t, fields, own):
        if "grid" in fields:
            t["sx"].launch_plan = t["fb"].launch_plan = own[0]
        if own[1] is not None:
            t["zo"].launch_plan = own[1]

    out = []
    for src, t, fields in runs:
        own = enter(t, fields)
        bits = same_bits(t, data)
        leave(t, fields, own)
        cs = calls(t, data)
        nw = {c[3]: t["keys"].n_key_words(c[3], BITS) for c in CASES}
        out.append({"src": src, "bits": bits, "cases": cs,
                    "bound_us": {k: bound_us(c[1], c[2], c[3], c[4],
                                             nw[c[4]])
                                 for k, c in cs.items()},
                    "kernel_us": {k: [] for k in cs}})
    floor = []
    order = list(range(len(runs)))
    for _ in range(args.reps):
        floor.append(event_us(lambda: one.fill_(0.0)))
        for i in order + order[::-1]:
            _, t, fields = runs[i]
            o = out[i]
            own = enter(t, fields)
            for name, c in o["cases"].items():
                o["kernel_us"][name].append(event_us(c[0], flushes[c[5]]))
            leave(t, fields, own)
    print(torch.cuda.get_device_name(0))
    print(json.dumps({"floor_us": statistics.median(floor), "rounds": floor}))
    for o in out:
        med = {k: statistics.median(v) for k, v in o["kernel_us"].items()}
        print(json.dumps({
            "src": o["src"], "bits": o["bits"], "median_us": med,
            "bound_share": {k: o["bound_us"][k] / v for k, v in med.items()},
            "bound_us": o["bound_us"], "rounds": o["kernel_us"]}))
    return 0 if all(b for o in out for b in o["bits"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
