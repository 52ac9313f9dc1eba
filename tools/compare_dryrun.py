#!/usr/bin/env python3
"""The dry run's memory a device: the reference's compiled cell against
the port's traced one, for one single-pod cell, on the CPU.

The reference's ``repro.launch.dryrun.run_cell(arch, shape, "single",
save=False)`` compiles the cell with XLA on 512 forced host devices (its
module sets ``--xla_force_host_platform_device_count`` at import, so it
runs in a process of its own) and reports ``memory_analysis``'s argument
and temp bytes; nothing is written under ``experiments/``.  The port's
``repro_torch.launch.dryrun.run_cell`` traces the same cell on meta
tensors over a fake 256-rank world (a second process) and reports its
argument bytes and its peak (``MemTracker``).  Both run at once.  The
line printed last sets the port's peak against the reference's argument
+ temp.

``--live N`` also lists, for the port, the N call sites whose op outputs
are live at the peak (by the autograd node running, the op and the
innermost frames of ``repro_torch``), bytes summed over each site's
storages: what holds the peak.  ``--collectives N`` lists the port's N
largest sums of the roofline's collective term (ms, as the dry run
prices each collective) by op, group size and call site (the innermost
frames of ``repro_torch``): what moves.  ``--src DIR`` traces another
tree's port (a checkout unpacked under ``build/``).  The cells are single-pod: the
reference's multi-pod cells do not compile on every jax.

Full-width cells of the 100B+ archs take minutes here (the reference's
compile, the port's trace), so this is not part of the tests::

    python3 tools/compare_dryrun.py --arch qwen1.5-110b --shape train_4k
    python3 tools/compare_dryrun.py --arch llama3-405b --shape train_4k \
        --live 20
    python3 tools/compare_dryrun.py --arch granite-moe-1b-a400m \
        --shape prefill_32k --collectives 8 --src build/parent/src
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GIB = 2 ** 30
CELL_S = 3600                   # each half's time limit


# the reference's half, run by ``python -c`` in a process of its own: it
# needs jax and the reference package, which this file imports nowhere
# (the port's half and the report run where jax is absent)
REFERENCE_CELL = (
    "import json, sys; import jax; "
    "from repro.launch.dryrun import run_cell; "
    "r = run_cell(sys.argv[1], sys.argv[2], 'single', save=False, "
    "verbose=False); "
    "print('RESULT ' + json.dumps({'status': r['status'], "
    "'memory': r.get('memory'), 'timings': r.get('timings'), "
    "'version': 'jax ' + jax.__version__}))")


def _site(depth: int) -> str:
    """The innermost three ``repro_torch`` frames (the dry run's own
    excepted) above frame ``depth`` of the caller."""
    f, frames = sys._getframe(depth + 1), []
    while f is not None and len(frames) < 3:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith(
                ("launch/hlo.py", "launch/dryrun.py")):
            frames.append(f"{name.split('repro_torch/')[-1]}:"
                          f"{f.f_lineno}:{f.f_code.co_name}")
        f = f.f_back
    return " < ".join(frames)


def _site_trace(base):
    """A subclass of the dry run's ``LocalTrace`` that keeps each
    collective record's call site beside it (``self.sites``)."""
    class Sites(base):
        def __init__(self):
            super().__init__()
            self.sites = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n = len(self.records)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            self.sites += [_site(1)] * (len(self.records) - n)
            return out

    return Sites


def _live_trace(base):
    """A subclass of the dry run's ``LocalTrace`` that also keeps every
    local op output's storage until it is freed, and a copy of the live
    set each time the total has grown 64 MiB past the last copy."""
    import weakref

    import torch
    from torch.distributed.tensor import DTensor

    def site(func):
        node = torch._C._current_autograd_node()
        return (type(node).__name__ if node is not None else "forward",
                func.overloadpacket.__name__, _site(2))

    class Live(base):
        def __init__(self):
            super().__init__()
            self.live, self.cur, self.peak = {}, 0, 0
            self.snap, self.snap_at = [], 0

        def _free(self, key):
            self.cur -= self.live.pop(key, (0,))[0]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            # a view or an in-place op returns an input's storage
            if out is NotImplemented or any(
                    r.alias_info is not None for r in func._schema.returns):
                return out
            ts = out if isinstance(out, (list, tuple)) else [out]
            for t in ts:
                if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                    continue
                st = t.untyped_storage()
                key = st._cdata
                if key in self.live:
                    continue
                ref = weakref.ref(st, lambda _, k=key: self._free(k))
                self.live[key] = (st.nbytes(), site(func), tuple(t.shape),
                                  str(t.dtype).replace("torch.", ""), ref)
                self.cur += st.nbytes()
                if self.cur > self.peak:
                    self.peak = self.cur
                    if self.peak > self.snap_at + 64 * 2 ** 20:
                        self.snap_at = self.peak
                        self.snap = [v[:4] for v in self.live.values()]
            return out

    return Live


def _collectives(trace, D, n: int) -> list:
    """The ``n`` largest sums of the collective term (ms) by op, group
    size and call site: ``[site, ms, link bytes, count]``."""
    from repro_torch.launch.hlo import _accounting
    sums = {}
    for (op, rbytes, ranks, *_), site in zip(trace.records, trace.sites):
        g = max(len(ranks), 1)
        link = _accounting(op, rbytes, g)[1]
        inter = len({r // D.GPUS_PER_NODE for r in ranks}) > 1
        e = sums.setdefault(f"{op} over {g} | {site}", [0.0, 0, 0])
        e[0] += 1e3 * link / (D.NET_BW if inter else D.NVLINK_BW)
        e[1] += link
        e[2] += 1
    return sorted(([k] + v for k, v in sums.items()),
                  key=lambda e: -e[1])[:n]


def _port(arch: str, shape: str, live: int, collectives: int) -> dict:
    import torch
    from repro_torch.launch import dryrun as D
    traces = []
    if live or collectives:
        cls = D.LocalTrace
        cls = _live_trace(cls) if live else cls
        cls = _site_trace(cls) if collectives else cls
        D.LocalTrace = lambda: traces.append(cls()) or traces[-1]
    D.init_fake_world(256)
    r = D.run_cell(arch, shape, "single", save=False, verbose=False)
    out = {"status": r["status"], "memory": r.get("memory"),
           "timings": r.get("timings"),
           "version": f"torch {torch.__version__}"}
    if collectives and traces:
        out["collectives"] = _collectives(traces[-1], D, collectives)
        out["collective_ms"] = r["roofline"]["collective_s"] * 1e3
    if live and traces:
        sites = {}
        for n, where, shp, dt in traces[-1].snap:
            e = sites.setdefault(" | ".join(where), [0, 0, shp, dt, 0])
            e[0] += n
            e[1] += 1
            if n > e[4]:            # the largest storage's tensor shows
                e[2:] = [shp, dt, n]
        sites = {k: v[:4] for k, v in sites.items()}
        out["live"] = sorted(([k] + v for k, v in sites.items()),
                             key=lambda e: -e[1])[:live]
        out["live_total"] = sum(v[0] for v in sites.values())
    return out


def _child(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", choices=("port",))
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--live", type=int, default=0)
    ap.add_argument("--collectives", type=int, default=0)
    a = ap.parse_args(argv)
    print("RESULT " + json.dumps(_port(a.arch, a.shape, a.live,
                                       a.collectives)))
    return 0


def _start(kind: str, src: Path, args) -> subprocess.Popen:
    if kind == "ref":
        cmd = [sys.executable, "-c", REFERENCE_CELL, args.arch, args.shape]
    else:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
               "port", "--arch", args.arch, "--shape", args.shape,
               "--live", str(args.live), "--collectives",
               str(args.collectives)]
    env = dict(os.environ, PYTHONPATH=str(src), JAX_PLATFORMS="cpu")
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(p: subprocess.Popen, what: str) -> dict:
    out, err = p.communicate(timeout=CELL_S)
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    if p.returncode != 0 or not lines:
        sys.exit(f"compare_dryrun: the {what} cell failed "
                 f"(exit {p.returncode}):\n{err[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--child" in argv:
        return _child(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the port's tree (default: this checkout's)")
    ap.add_argument("--live", type=int, default=0, metavar="N",
                    help="list the N call sites live at the port's peak")
    ap.add_argument("--collectives", type=int, default=0, metavar="N",
                    help="list the port's N largest collective sums by "
                         "op, group and call site")
    args = ap.parse_args(argv)
    t0 = time.time()
    ref = _start("ref", ROOT / "src", args)
    port = _start("port", Path(args.src).resolve(), args)
    try:
        r, p = _result(ref, "reference"), _result(port, "port")
    finally:
        for q in (ref, port):
            if q.poll() is None:
                q.kill()
                q.wait()
    print(f"{args.arch} x {args.shape}, single pod: {r['version']}, "
          f"{p['version']}, on the CPU; "
          f"{time.time() - t0:.1f} s of wall")
    if r["status"] != "ok" or p["status"] != "ok":
        print(f"reference {r['status']}, port {p['status']}")
        return 1
    rm, pm = r["memory"], p["memory"]
    ref_total = rm["argument_size_in_bytes"] + rm["temp_size_in_bytes"]
    print(f"reference: argument {rm['argument_size_in_bytes'] / GIB:.2f} "
          f"GiB + temp {rm['temp_size_in_bytes'] / GIB:.2f} GiB = "
          f"{ref_total / GIB:.2f} GiB (compile "
          f"{r['timings']['compile_s']:.1f} s)")
    print(f"port:      argument {pm['argument_size_in_bytes'] / GIB:.2f} "
          f"GiB, peak {pm['peak_memory_in_bytes'] / GIB:.2f} GiB (trace "
          f"{p['timings']['trace_s']:.1f} s)")
    for site, n, count, shape, dtype in p.get("live", []):
        print(f"  {n / GIB:8.3f} GiB {count:5d}x  {dtype}{list(shape)}  "
              f"{site}")
    if "live_total" in p:
        print(f"  live op outputs at the peak: {p['live_total'] / GIB:.2f} "
              f"GiB")
    if "collectives" in p:
        print(f"port's collective term: {p['collective_ms']:.4f} ms")
        for site, ms, link, count in p["collectives"]:
            print(f"  {ms:12.4f} ms {link / GIB:9.3f} GiB {count:5d}x  "
                  f"{site}")
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "reference_arg_temp_bytes": ref_total,
                      "port_peak_bytes": pm["peak_memory_in_bytes"],
                      "port_over_reference":
                          pm["peak_memory_in_bytes"] / ref_total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
