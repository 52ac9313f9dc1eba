#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port of Coconut (``src/repro_torch``).

Run from the repository root on a machine with one CUDA GPU::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each one against its plain PyTorch twin, then drives the port's main
path at the paper's deployment (``configs/coconut_paper.py``: L=256, w=16,
b=8, leaf 2000) over 8,388,608 z-normalized random walks made on the card:
the Coconut-Tree build, batched exact k-NN (Q=64, k=10) through the eager
kernel chain and through the fused ``scan_verify`` kernel, single-query
parity, and a brute-force check.  Then the storage path over the same
walks: an on-disk segment bulk-loaded by external sort (``sax_summarize``
+ ``zorder`` per chunk, then a merge of the spills), its columns held
against the tree's, exact k-NN straight off the file (``unpack_mindist``
per leaf group), through the tiered leaf store, and ``tree.load`` of the
file.  Then every kernel is timed at the main path's shapes (the cross
form of ``batch_euclid`` at the densest leaf group, at the eager batch's
median rows per launch and at Q=1; ``zorder`` also over the tree's
8,388,608 rows, and at the chunk with the L2 warm and flushed by a read)
beside its bound, its twin and, where one exists, a PyTorch library
call.  Every phase raises on failure.  The
last lines are the kernels' JSON record, the card's name and power
limit, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

DEVICE = "cuda"
N_ROWS = 8_388_608          # the paper's deployment scale, cut to one card
GEN_CHUNK = 1 << 20
N_QUERIES = 64
K = 10
SEED = 0
# H100 SXM peaks.  Memory: the data sheet's 3.35 TB/s.  FP32: the data
# sheet's 67 TFLOP/s counts a fused multiply-add as two operations; the
# kernels forbid FMA contraction (csrc/common.cuh), so each sub, mul and add
# is one instruction, at 128 lanes x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
SEG_CHUNK = 65_536          # rows per host chunk fed to the external sort
MERGE_BATCH = 2048          # rows read from each spill per merge round
TIER_DEVICE_BYTES = 128 << 20   # holds every packed code block (N x 16 B)
TIMED = 20                  # kernel launches per median
PLAIN_TIMED = 3             # plain-twin calls per median
PROFILED_CALLS = 200        # scan_verify calls per operations-per-call profile
FLUSH_BYTES = 256 << 20     # > the 50 MB L2: a cold cache between launches


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str) -> None:
    if not bool(cond):
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


class Timer:
    """Kernel times from CUDA events: warmed up, then the median of
    single launches, each behind a spin so the host's enqueue time is
    not counted, optionally with the L2 flushed before every launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                 device=DEVICE)

    def ms(self, fn, reps: int = TIMED, cold: bool = True,
           read: bool = False) -> float:
        """``cold``: the L2 flushed by zeroing 256 MiB, which leaves it
        full of dirty lines, or with ``read`` by reading them."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            if cold and read:
                self.flush.max()
            elif cold:
                self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: float, ops: float):
    """The least time for moving ``nbytes`` and issuing ``ops`` FP32
    instructions, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain twin at ragged shapes
# ---------------------------------------------------------------------------

def max_abs_err(torch, a, b) -> float:
    """Largest |a - b| over the entries where ``b`` is finite; the
    non-finite entries must sit in the same places."""
    torch.cuda.synchronize()
    a, b = a.cpu(), b.cpu()
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.dtype.is_floating_point:
        fin = torch.isfinite(b)
        check(torch.equal(torch.isfinite(a), fin), "non-finite entries differ")
        return float((a[fin].double() - b[fin].double()).abs().max()) \
            if fin.any() else 0.0
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def kernel_phase(torch, np, S, ops, ref, pack_codes, dev) -> dict:
    """Max abs error per kernel (the tolerance is 0: kernels and twins do
    the same float operations in the same order, with no FMA)."""
    err = {}

    def launched(out):
        torch.cuda.synchronize()     # a fault shows up at its launch
        return out

    def same(name, a, b):
        e = max_abs_err(torch, a, b)
        err[name] = max(err.get(name, 0.0), e)
        check(e == 0, f"{name}: kernel differs from its plain twin by {e}")

    rng = np.random.default_rng(SEED)
    for b in (1, 4, 8):
        for cfg in (S.SummaryConfig(64, 8, b), S.SummaryConfig(256, 16, b)):
            for n in (257, 2037):
                x = walks(np, rng, n, cfg.series_len)
                xt = torch.from_numpy(x).to(dev)
                for nq in (1, 8, 64):
                    qt = torch.from_numpy(
                        walks(np, rng, nq, cfg.series_len)).to(dev)
                    _, codes = S.summarize(xt, cfg)
                    q_paas = S.paa(qt, cfg.segments)
                    lower, upper = S.region_bounds(b, device=dev)
                    scale = cfg.series_len / cfg.segments
                    md = launched(ops.mindist_batch(q_paas, codes, cfg))
                    same("mindist_batch", md, ref.mindist_batch_ref(
                        q_paas, codes, lower, upper, scale))
                    same("mindist_batch",
                         launched(ops.mindist(q_paas[0], codes, cfg)), md[0])
                    ed = launched(ops.batch_euclid_multi(qt, xt))
                    same("batch_euclid", ed, ref.batch_euclid_ref(qt, xt))
                    idx = torch.from_numpy(
                        rng.integers(0, n, (nq, 333))).to(dev)
                    same("batch_euclid_gather",
                         launched(ops.batch_euclid_multi(qt, xt, idx=idx)),
                         ref.batch_euclid_gather_ref(qt, xt, idx))
                    bound = ed.median(dim=1).values
                    dead = torch.from_numpy(rng.random(n) < 0.2).to(dev)
                    for k in (1, 10):
                        got = launched(ops.scan_verify(
                            qt, q_paas, codes, xt, bound, cfg, k=k,
                            dead=dead))
                        want = ref.scan_verify_ref(
                            qt, q_paas, codes, xt, lower, upper, bound,
                            dead.to(torch.int32), scale=scale, k=k)
                        for g, w_ in zip(got, want):
                            same("scan_verify", g, w_)
                got = launched(ops.summarize_and_key(xt, cfg))
                want = ref.fused_build_ref(
                    xt, S.breakpoints(b, device=dev), segments=cfg.segments,
                    bits=b)
                for g, w_ in zip(got, want):
                    same("fused_build", g, w_)
    # the cross form at lengths that are not a multiple of 32 and span
    # several shared-memory chunks, through the 16-byte (L=300) and the
    # 4-byte (L=301) copies; the gathered form gives the same bits
    for L in (300, 301):
        for n in (257, 2037):
            xt = torch.from_numpy(walks(np, rng, n, L)).to(dev)
            for nq in (1, 17, 64):
                qt = torch.from_numpy(walks(np, rng, nq, L)).to(dev)
                ed = launched(ops.batch_euclid_multi(qt, xt))
                same("batch_euclid", ed, ref.batch_euclid_ref(qt, xt))
                idx = torch.from_numpy(rng.integers(0, n, (nq, 33))).to(dev)
                same("batch_euclid_gather",
                     launched(ops.batch_euclid_multi(qt, xt, idx=idx)),
                     torch.gather(ed, 1, idx))
    # the storage path's kernels, also at b = 3, 5 (packed symbols that
    # straddle bytes) and at a shape of the summarize tile's generic path
    # (L = 300, w = 12, zorder's run_word) and at w = 64 (a row across two
    # warps), each against its twin and against the kernels it must equal:
    # sax_summarize + zorder == fused_build, unpack_mindist == mindist_batch
    # on the decoded codes
    for b in (1, 3, 4, 5, 8):
        for cfg in (S.SummaryConfig(64, 8, b), S.SummaryConfig(256, 16, b),
                    S.SummaryConfig(300, 12, b), S.SummaryConfig(256, 64, b)):
            lower, upper = S.region_bounds(b, device=dev)
            bps = S.breakpoints(b, device=dev)
            scale = cfg.series_len / cfg.segments
            for n in (257, 2037):
                xt = torch.from_numpy(walks(np, rng, n, cfg.series_len)).to(dev)
                paa, codes = launched(ops.sax_summarize(xt, cfg))
                r_paa, r_codes = ref.sax_summarize_ref(
                    xt, bps, segments=cfg.segments)
                same("sax_summarize", paa, r_paa)
                same("sax_summarize", codes, r_codes)
                keys = launched(ops.zorder(codes, cfg))
                same("zorder", keys, ref.zorder_ref(codes, w=cfg.segments,
                                                    b=b))
                for g, w_ in zip((paa, codes, keys),
                                 ops.summarize_and_key(xt, cfg)):
                    same("sax_summarize+zorder vs fused_build", g, w_)
                packed = torch.from_numpy(
                    pack_codes(codes.cpu().numpy(), b)).to(dev)
                for nq in (1, 8, 64):
                    q_paas = S.paa(torch.from_numpy(walks(
                        np, rng, nq, cfg.series_len)).to(dev), cfg.segments)
                    md = launched(ops.mindist_batch_packed(q_paas, packed,
                                                           cfg))
                    same("unpack_mindist", md, ref.mindist_batch_packed_ref(
                        q_paas, packed, lower, upper, scale,
                        w=cfg.segments, b=b))
                    same("unpack_mindist vs mindist_batch", md,
                         ops.mindist_batch(q_paas, codes, cfg))
    return err


def walks(np, rng, n, L):
    x = np.cumsum(rng.standard_normal((n, L)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# phases 3-7: the main path at full width
# ---------------------------------------------------------------------------

def make_data(torch, series, gen, n, L):
    x = torch.empty((n, L), dtype=torch.float32, device=DEVICE)
    for s in range(0, n, GEN_CHUNK):
        x[s:s + GEN_CHUNK] = series.random_walk(gen, min(GEN_CHUNK, n - s), L)
    return x


def brute_force(torch, tree, queries, k):
    """Blocked plain-torch exact k-NN over every row: an fp32 matmul
    selects each block's 64 nearest candidates, which are re-scored with
    the direct diff-square-sum and merged (stable on ties)."""
    q = queries
    qn = (q * q).sum(1, keepdim=True)
    cand_d, cand_i = [], []
    raw = tree.raw
    step = 1 << 20
    for s in range(0, tree.n, step):
        blk = raw[s:s + step]
        approx = qn - 2.0 * (q @ blk.T) + (blk * blk).sum(1)[None, :]
        sel = torch.topk(approx, 64, dim=1, largest=False).indices + s
        rows = raw[sel]                                    # [Q, 64, L]
        cand_d.append(((rows - q[:, None, :]) ** 2).sum(-1))
        cand_i.append(sel)
    d = torch.cat(cand_d, 1)
    i = torch.cat(cand_i, 1)
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return (torch.gather(d, 1, order).cpu().numpy(),
            tree.offsets[torch.gather(i, 1, order)].cpu().numpy())


def device_profile(torch, fn, reps: int = 1, top: int = 8):
    """Device time of ``reps`` runs of ``fn`` (torch.profiler): returns
    (total ms, [(ms, count, name)] for every device operation: kernels,
    fills, copies), largest first, and prints the ``top`` entries."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    for t, c, key in rows[:top]:
        print(f"  profile {t:10.3f} ms {c:6d}x  {key[:90]}")
    return sum(r[0] for r in rows), rows


def kernel_total(rows, key: str, what: str, over: str = "one batch") -> None:
    """Print the device total and per-launch mean of the profiled kernels
    whose name holds ``key`` (rows of :func:`device_profile` over ``over``)."""
    sel = [r for r in rows if key in r[2]]
    ms, n = sum(r[0] for r in sel), sum(r[1] for r in sel)
    print(f"{what} (torch.profiler, {over}): "
          + (f"{ms:.3f} ms in {n} launches ({1e3 * ms / n:.2f} us each)"
             if n else "not measured (the profiler recorded none)"))


# ---------------------------------------------------------------------------
# phase 8: the storage path over the same walks
# ---------------------------------------------------------------------------

def same_answers(np, a, b, what: str) -> None:
    (d1, o1), (d2, o2) = a, b
    check(np.array_equal(o1, o2), f"{what}: ids differ from the tree's")
    check(np.array_equal(np.ascontiguousarray(d1, np.float32).view(np.uint32),
                         np.ascontiguousarray(d2, np.float32).view(np.uint32)),
          f"{what}: dists are not bitwise equal to the tree's")


def split_line(stats) -> str:
    tm = stats.timings
    staged = sum(tm.get(s, 0.0) for s in ("seed", "bound", "verify", "merge"))
    return (", ".join(f"{s}={tm.get(s, 0.0) / 1e3:.3f}"
                      for s in ("plan", "seed", "bound", "verify", "merge"))
            + f", host-other={(tm['scan'] - staged) / 1e3:.3f}, "
            f"scan={tm['scan'] / 1e3:.3f}")


def segment_phase(torch, np, x, tree, queries, tree_answer) -> dict:
    """Bulk-load a segment from ``x`` by external sort, hold its columns
    against ``tree``, search it (plain and tiered) and reload it; every
    answer bitwise equal to ``tree_answer``.  The work directory goes at
    the end, on failure too."""
    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.core import tree as T
    from repro_torch.core.metrics import IOStats
    from repro_torch.kernels import loader
    from repro_torch.query import Partition, exact_knn
    from repro_torch.storage import (TieredLeafStore, build_external,
                                     exact_search_mmap)
    from repro_torch.storage.packing import packed_code_width
    cfg, leaf = INDEX, LEAF_SIZE
    n, L, w = tree.n, cfg.series_len, cfg.segments
    pw = packed_code_width(w, cfg.bits)
    out = {"launches": {}}
    work = ROOT / "build" / "segment_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        # spills and output each take about a row of every column
        need = 2 * n * (L * 4 + w * 4 + pw + 8 + cfg.n_words * 4) + (1 << 30)
        free = shutil.disk_usage(work).free
        print(f"segment: {free / 2**30:.1f} GiB free on the build disk, "
              f"{need / 2**30:.1f} GiB needed")
        check(free >= need, f"segment: {free} bytes free on disk, {need} "
                            "needed for the spills and the output")

        # -- 8a: bulk load from host chunks ---------------------------------
        chunks = (x[s:s + SEG_CHUNK].cpu().numpy()
                  for s in range(0, n, SEG_CHUNK))
        times = {}
        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        seg = build_external(chunks, cfg, workdir=str(work),
                             chunk_size=SEG_CHUNK, leaf_size=leaf,
                             merge_batch=MERGE_BATCH, times=times)
        build_s = time.perf_counter() - t0
        out["launches"]["build"] = dict(loader.LAUNCHES)
        for name in ("sax_summarize", "zorder"):
            check(loader.LAUNCHES.get(name, 0) == -(-n // SEG_CHUNK),
                  f"external sort launched {name} "
                  f"{loader.LAUNCHES.get(name, 0)} times")
        v2_row = cfg.n_words * 4 + w + w * 4 + 8 + L * 4
        idx_v3 = (seg.columns["keys"].nbytes + seg.columns["codes"].nbytes) / n
        print(f"segment build: {n} rows in {build_s:.2f} s (pass 1 "
              f"{times['pass1']:.2f} s, pass 2 {times['pass2']:.2f} s); "
              f"file {seg.nbytes} bytes = {seg.nbytes / n:.2f} B/row "
              f"(v2 layout {v2_row} B/row); keys+codes {idx_v3:.2f} B/row "
              f"(v2 {cfg.n_words * 4 + w} B/row); launches "
              f"{out['launches']['build']}")

        # -- 8b: the segment's columns == the tree's ------------------------
        t0 = time.perf_counter()
        dev = tree.device
        step = 128 * leaf
        for s in range(0, n, step):
            e = min(s + step, n)
            for name, got, want in (
                    ("keys", seg.keys[s:e], tree.keys[s:e]),
                    ("codes", seg.codes[s:e], tree.codes[s:e]),
                    ("paas", seg.paas[s:e], tree.paas[s:e]),
                    ("offsets", seg.offsets[s:e], tree.offsets[s:e]),
                    ("raw", seg.raw[s:e], tree.raw[s:e])):
                a = np.array(got)
                if a.dtype == np.uint32:        # key words on disk
                    a = a.astype(np.int64)
                g = torch.from_numpy(a).to(dev)
                if g.dtype == torch.float32:
                    g, want = g.view(torch.int32), want.view(torch.int32)
                check(torch.equal(g.to(want.dtype), want),
                      f"segment {name} rows {s}:{e} differ from the tree's")
        print(f"segment columns: keys, codes, paas, offsets and raw bitwise "
              f"equal to the in-memory tree's (external sax_summarize + "
              f"zorder vs fused_build) in {time.perf_counter() - t0:.2f} s")

        # -- 8c: exact search off the file ----------------------------------
        runs = []
        for rep_i in range(3):
            io = IOStats()
            loader.LAUNCHES.clear()
            t0 = time.perf_counter()
            d, o, st = exact_search_mmap(seg, queries, k=K, io=io)
            runs.append((time.perf_counter() - t0, io, st,
                         dict(loader.LAUNCHES)))
            same_answers(np, (d, o), tree_answer, "segment search")
        first_s, _, _, first_l = runs[0]
        warm_s, io, st, lw = runs[-1]
        out["launches"]["search"] = first_l
        check(lw.get("unpack_mindist", 0) == st.leaves_scanned > 0,
              f"unpack_mindist launched {lw.get('unpack_mindist', 0)} times "
              f"for {st.leaves_scanned} scanned one-leaf groups")
        print(f"segment search: Q={N_QUERIES} k={K}: {first_s:.3f} s first "
              f"batch, {runs[1][0]:.3f} / {warm_s:.3f} s warm; answers "
              f"bitwise equal to the tree's; launches {lw}")
        print(f"segment split (s): {split_line(st)}")
        print(f"segment io: {io.as_dict()}; scan_bytes={st.scan_bytes} "
              f"leaves_scanned={st.leaves_scanned} "
              f"leaves_pruned={st.leaves_pruned}")
        busy, s_prof = device_profile(
            torch, lambda: exact_search_mmap(seg, queries, k=K))
        print(f"segment device busy (torch.profiler, kernel time in one "
              f"batch): {busy:.3f} ms of {warm_s * 1e3:.1f} ms wall "
              f"({100 * busy / (warm_s * 1e3):.2f}%)")
        kernel_total(s_prof, "UnpackMindist",
                     "segment unpack_mindist kernels")

        # -- 8d: tiered leaf store ------------------------------------------
        tiers = TieredLeafStore(2 * TIER_DEVICE_BYTES,
                                device_capacity_bytes=TIER_DEVICE_BYTES,
                                promote_touches=1)
        part = Partition.from_segment(seg, tiers=tiers)
        # blocks are admitted on a miss and promoted on a later hit (the
        # reference's policy): batch 1 fills the host tier, batch 2
        # promotes, batch 3 runs from device-resident blocks only
        tier_runs = []
        for label in ("fill", "promote", "hot"):
            before = tiers.stats()
            loader.LAUNCHES.clear()
            t0 = time.perf_counter()
            d, o, st_t = exact_knn([part], queries, cfg, k=K)
            dt = time.perf_counter() - t0
            after = tiers.stats()
            same_answers(np, (d, o), tree_answer, f"tiered search ({label})")
            delta = {k_: after[k_] - before[k_] for k_ in
                     ("hits", "misses", "promotions", "bytes_saved")}
            tier_runs.append((label, dt, delta, dict(loader.LAUNCHES)))
            print(f"tiered {label}: {dt:.3f} s; {delta}; device_bytes "
                  f"{after['device_bytes']}; split (s): {split_line(st_t)}")
        _, hot_s, hot_delta, hot_l = tier_runs[-1]
        check(hot_delta["misses"] == 0 and hot_delta["promotions"] == 0
              and tiers.device_bytes == n * pw,
              "tiered: the hot batch read code blocks that were not on "
              f"the device ({hot_delta}, {tiers.device_bytes} B resident)")
        out["launches"]["tiered_hot"] = hot_l
        kernel_total(device_profile(
            torch, lambda: exact_knn([part], queries, cfg, k=K))[1],
            "UnpackMindist", "tiered hot unpack_mindist kernels")
        out["tiers"] = tiers.stats()

        # inputs for the unpack_mindist timings: leaf 0's packed codes,
        # read off the file and as a hot-tier block
        li = 0
        out["packed_host"] = np.array(
            seg.columns["codes"][li * leaf:(li + 1) * leaf])
        hot = tiers.cache.get((part.cache_token, "codes", li)).value
        check(isinstance(hot, torch.Tensor) and hot.device == tree.device,
              "tiered: leaf 0's code block is not on the tree's device")
        out["packed_hot"] = hot

        # -- 8e: round trip -------------------------------------------------
        path = seg.path
        seg.close()
        t0 = time.perf_counter()
        loaded = T.load(path)
        load_s = time.perf_counter() - t0
        d, o, _ = T.exact_search_batch(loaded, queries, k=K)
        same_answers(np, (d, o), tree_answer, "tree.load")
        print(f"round trip: tree.load in {load_s:.2f} s on "
              f"{loaded.device}; answers bitwise equal to the tree's")
        del loaded
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.core.keys import key_less
    from repro_torch.core import summarization as S
    from repro_torch.core import tree as T
    from repro_torch.data import series
    from repro_torch.kernels import loader, ops, ref
    from repro_torch.query import Partition, build_plan, exact_knn
    from repro_torch.storage.packing import pack_codes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()

    # -- 0: versions ---------------------------------------------------------
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(card)

    # -- 1: build the kernels --------------------------------------------------
    t0 = time.perf_counter()
    lib_path = loader.build()
    loader.library()
    print(f"build: kernels built in {time.perf_counter() - t0:.1f} s "
          f"({lib_path.relative_to(ROOT)})")
    for log in sorted(lib_path.parent.glob("*.log")):
        regs = [ln.split(":", 1)[1].strip() for ln in
                log.read_text().splitlines() if "Used" in ln]
        if regs:
            print(f"  ptxas {log.stem}: {'; '.join(regs)}")

    # -- 2: every kernel against its plain twin --------------------------------
    t0 = time.perf_counter()
    errs = kernel_phase(torch, np, S, ops, ref, pack_codes, dev)
    print(f"kernels: all equal to their plain twins (max abs err "
          f"{max(errs.values())}) in {time.perf_counter() - t0:.1f} s")

    # -- 3: build the tree at full width ---------------------------------------
    cfg, leaf = INDEX, LEAF_SIZE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    x = make_data(torch, series, gen, N_ROWS, cfg.series_len)
    queries = series.query_workload(gen, x, N_QUERIES)
    torch.cuda.synchronize()
    print(f"data: {N_ROWS} x {cfg.series_len} random walks in "
          f"{time.perf_counter() - t0:.2f} s")
    loader.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = T.build(x, cfg, leaf_size=leaf)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = dict(loader.LAUNCHES)
    check(build_launches.get("fused_build", 0) > 0,
          f"build launched no fused_build: {build_launches}")
    check(not key_less(tree.keys[1:], tree.keys[:-1]).any(),
          "keys not lexicographically non-decreasing")
    check(torch.equal(torch.sort(tree.offsets).values,
                      torch.arange(tree.n, device=dev)),
          "offsets are not a permutation")
    sample = slice(0, 1 << 16)
    want = ref.fused_build_ref(tree.raw[sample], S.breakpoints(cfg.bits,
                                                               device=dev),
                               segments=cfg.segments, bits=cfg.bits)
    for got, w_ in zip((tree.paas[sample], tree.codes[sample],
                        tree.keys[sample]), want):
        check(torch.equal(got, w_), "tree summaries differ from the twin")
    print(f"build: {tree.n} rows, {tree.n_leaves} leaves in {build_s:.3f} s; "
          f"launches {build_launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print("build device profile (torch.profiler, a second tree build):")
    _, b_prof = device_profile(torch, lambda: T.build(x, cfg, leaf_size=leaf))
    kernel_total(b_prof, "FusedBuild", "fused_build kernels", "one build")

    # -- 4: eager batched exact search -----------------------------------------
    # the first batch records the rows of every cross-form launch (the
    # executor verifies one leaf group's union-live rows per launch)
    cross_rows = []
    euclid_multi = ops.batch_euclid_multi

    def counted_euclid(queries_, series_, idx=None):
        if idx is None:
            cross_rows.append(series_.shape[0])
        return euclid_multi(queries_, series_, idx=idx)

    loader.LAUNCHES.clear()
    ops.batch_euclid_multi = counted_euclid
    try:
        t0 = time.perf_counter()
        e_d, e_o, e_stats = T.exact_search_batch(tree, queries, k=K)
        eager_cold_s = time.perf_counter() - t0
    finally:
        ops.batch_euclid_multi = euclid_multi
    eager_launches = dict(loader.LAUNCHES)
    for name in ("mindist_batch", "batch_euclid", "batch_euclid_gather"):
        check(eager_launches.get(name, 0) > 0,
              f"eager search launched no {name}: {eager_launches}")
    t0 = time.perf_counter()
    e_d2, e_o2, e_stats2 = T.exact_search_batch(tree, queries, k=K)
    eager_s = time.perf_counter() - t0
    check(np.array_equal(e_o, e_o2) and np.array_equal(e_d, e_d2),
          "two eager runs disagree")
    tm = e_stats2.timings
    staged = sum(tm.get(s, 0.0) for s in ("seed", "bound", "verify", "merge"))
    host = tm["scan"] - staged
    print(f"eager: Q={N_QUERIES} k={K}: {eager_cold_s:.3f} s first batch, "
          f"{eager_s:.3f} s per batch warm; launches {eager_launches}")
    print("eager split (s): " + ", ".join(
        f"{s}={tm.get(s, 0.0) / 1e3:.3f}"
        for s in ("plan", "seed", "bound", "verify", "merge"))
        + f", host-other={host / 1e3:.3f}, scan={tm['scan'] / 1e3:.3f}")
    print(f"eager stats: leaves_scanned={e_stats2.leaves_scanned} "
          f"leaves_pruned={e_stats2.leaves_pruned} "
          f"candidates={e_stats2.candidates} "
          f"pruned_frac={e_stats2.pruned_frac:.6f} "
          f"leaves_touched={e_stats2.leaves_touched}")
    cr = np.asarray(cross_rows)
    # the sequence, for tools/compare_cross.py
    (ROOT / "build").mkdir(exist_ok=True)
    np.save(ROOT / "build" / "eager_cross_rows.npy", cr)
    median_rows = max(1, int(np.median(cr)))
    print(f"eager cross launches: {len(cr)} calls ({eager_launches.get('batch_euclid', 0)} "
          f"counted by the wrapper); rows per call min {cr.min()} median "
          f"{np.median(cr):g} p90 {np.percentile(cr, 90):g} max {cr.max()}, "
          f"{int(cr.sum())} rows in all")
    busy, e_prof = device_profile(
        torch, lambda: T.exact_search_batch(tree, queries, k=K))
    print(f"eager device busy (torch.profiler, kernel time in one batch): "
          f"{busy:.3f} ms of {eager_s * 1e3:.1f} ms wall "
          f"({100 * busy / (eager_s * 1e3):.2f}%)")
    kernel_total(e_prof, "euclid_cross", "eager batch_euclid cross kernels")
    kernel_total(e_prof, "MindistBatch", "eager mindist_batch kernels")

    # -- 5: fused search ---------------------------------------------------------
    part = Partition.from_tree(tree)

    def fused():
        return exact_knn([part], queries, cfg, k=K, scan_mode="kernel")

    loader.LAUNCHES.clear()
    t0 = time.perf_counter()
    f_d, f_o, f_stats = fused()
    fused_s = time.perf_counter() - t0
    fused_launches = dict(loader.LAUNCHES)
    sv_calls = fused_launches.get("scan_verify", 0)
    check(sv_calls > 0,
          f"fused search launched no scan_verify: {fused_launches}")
    check(np.array_equal(f_o, e_o), "fused ids differ from eager")
    check(np.array_equal(f_d.view(np.uint32), e_d.view(np.uint32)),
          "fused dists are not bitwise equal to eager")
    t0 = time.perf_counter()
    f_d2, f_o2, f_stats2 = fused()
    fused_warm_s = time.perf_counter() - t0
    check(np.array_equal(f_o2, f_o)
          and np.array_equal(f_d2.view(np.uint32), f_d.view(np.uint32)),
          "two fused runs disagree")
    print(f"fused: {fused_s:.3f} s first batch, {fused_warm_s:.3f} s warm; "
          f"launches {fused_launches}; equal to eager (ids, dist bits); "
          f"leaves_scanned={f_stats.leaves_scanned} "
          f"candidates={f_stats.candidates} (eager {e_stats.candidates})")
    print(f"fused split (s): {split_line(f_stats2)}")
    busy, prof_rows = device_profile(torch, fused)
    sv_rows = [r for r in prof_rows if "scan_verify" in r[2]]
    sv_ms = sum(r[0] for r in sv_rows)
    sv_kernels = sum(r[1] for r in sv_rows)
    print(f"fused device busy (torch.profiler, device time in one batch): "
          f"{busy:.3f} ms of {fused_warm_s * 1e3:.1f} ms wall "
          f"({100 * busy / (fused_warm_s * 1e3):.2f}%); scan_verify kernels "
          + (f"{sv_ms:.3f} ms in {sv_kernels} launches over {sv_calls} calls "
             f"({sv_kernels / sv_calls:.2f} kernels per call, "
             f"{1e3 * sv_ms / sv_calls:.2f} us per call)" if sv_kernels else
             f"not measured (the profiler recorded none of {sv_calls} "
             f"calls' kernels)"))

    # -- 6: single == batch --------------------------------------------------------
    for qi in (0, 1, N_QUERIES // 2, N_QUERIES - 1):
        s_d, s_o, _ = T.exact_search(tree, queries[qi], k=K)
        check(np.array_equal(s_o, e_o[qi])
              and np.array_equal(s_d.view(np.uint32),
                                 e_d[qi].view(np.uint32)),
              f"single query {qi} differs from its batch row")
    print("single == batch: bitwise for 4 queries")

    # -- 7: brute force ------------------------------------------------------------
    t0 = time.perf_counter()
    b_d, b_o = brute_force(torch, tree, queries, K)
    diff = b_o != e_o
    ties_ok = np.allclose(b_d[diff], e_d[diff], rtol=1e-5)
    check(not diff.any() or ties_ok,
          f"{int(diff.sum())} answer ids differ from brute force")
    check(np.allclose(b_d, e_d, rtol=1e-5), "dists differ from brute force")
    print(f"brute force: ids agree ({int(diff.sum())} tie swaps), dists "
          f"within rtol 1e-5, in {time.perf_counter() - t0:.2f} s")

    # -- 8: the storage path ---------------------------------------------------
    t0 = time.perf_counter()
    seg_out = segment_phase(torch, np, x, tree, queries, (e_d, e_o))
    del x
    torch.cuda.empty_cache()
    print(f"segment phase: {time.perf_counter() - t0:.1f} s")

    # -- 9: each kernel at the main path's shapes ----------------------------------
    timer = Timer(torch)
    q = queries.contiguous()
    q_paas = S.paa(q, cfg.segments)
    plan = build_plan([part], q_paas.cpu().numpy())
    first = int(np.argmin(plan.entries[0].leaf_bounds.min(axis=0)))
    rows = slice(first * leaf, min((first + 1) * leaf, tree.n))
    codes_leaf, raw_leaf = tree.codes[rows], tree.raw[rows]
    seed_idx = T._seed_index(tree, q)
    seed_d = ops.batch_euclid_multi(q, tree.raw, idx=seed_idx)
    bound = torch.sort(seed_d, dim=1).values[:, K - 1].contiguous()
    lower, upper, bps = ops._tables(cfg.bits, dev)
    scale = cfg.series_len / cfg.segments
    md = ops.mindist_batch(q_paas, codes_leaf, cfg)
    keep = (md < bound[:, None]).any(0)
    verify_rows = raw_leaf[keep].contiguous()
    nq, L, w = N_QUERIES, cfg.series_len, cfg.segments
    nl = codes_leaf.shape[0]
    nv = verify_rows.shape[0]
    # the cross form's typical launch: the eager batch's median row count
    nm = min(median_rows, nl)
    median_rows_t = raw_leaf[:nm]
    c = seed_idx.shape[1]
    uniq = int(torch.unique(seed_idx).numel())
    sv = ops.scan_verify(q, q_paas, codes_leaf, raw_leaf, bound, cfg, k=K)
    live_pairs, union = int(sv[2].sum()), int(sv[3])
    # the tightest bound the batch reaches: each query's final k-th distance
    bound_t = torch.from_numpy(np.ascontiguousarray(e_d[:, K - 1])).to(dev)
    sv_t = ops.scan_verify(q, q_paas, codes_leaf, raw_leaf, bound_t, cfg,
                           k=K)
    live_pairs_t, union_t = int(sv_t[2].sum()), int(sv_t[3])
    # queries with a live pair: only their raw rows need to be read
    live_q, live_q_t = int((sv[2] > 0).sum()), int((sv_t[2] > 0).sum())
    per_q = sv[2].cpu().numpy()
    live_md = md < bound[:, None]
    densest = max(int(live_md[:, s:s + 256].sum(1).max())
                  for s in range(0, nl, 256))
    print(f"scan_verify inputs (leaf {first}, {nl} rows): seed bound "
          f"{live_pairs} live pairs, {union} live rows, live rows per query "
          f"min {per_q.min()} median {int(np.median(per_q))} max "
          f"{per_q.max()}, densest (256-row tile, query) {densest}; tight "
          f"bound {live_pairs_t} live pairs, {union_t} live rows")
    no_dead = torch.zeros(nl, dtype=torch.int32, device=dev)
    card = 1 << cfg.bits

    def euclid_bound(nq_, n_):
        """The cross form's least work: the queries and rows read once, the
        [Q, N] output written once; per pair, L subs and L muls and the
        L - 1 adds that sum L squares (each lane's first add is onto 0.f
        and changes no bits; the lanes' L - 32 adds and the fold's 31)."""
        return bound_ms((nq_ + n_) * L * 4 + nq_ * n_ * 4,
                        nq_ * n_ * (3 * L - 1))

    def sv_bound(live_rows, live_queries, pairs):
        """scan_verify's least work: the leaf's codes, the live rows and
        the raw rows of the queries with a live pair, once each; every
        query's PAA, bound and count; the two breakpoint tables; the
        outputs.  The bound for every (query, row) (7w each, as
        md_bound's), the ED of the live pairs (3L - 1 each, as the cross
        form's)."""
        return bound_ms(nl * w + (live_rows + live_queries) * L * 4
                        + nq * (w + 2) * 4 + 2 * card * 4 + nq * K * 8 + 4,
                        nq * nl * 7 * w + (3 * L - 1) * pairs)

    def md_bound(nq_, n_, row_bytes):
        """The bound kernels' least work: the rows, the queries' PAAs and
        the region tables read once, the [Q, N] output written once; per
        pair w x (2 subs, 2 max, add, mul), the w - 1 adds that sum the
        terms (the first add is onto 0.f and changes no bits) and the
        scale: 7w."""
        return bound_ms(n_ * row_bytes + nq_ * w * 4 + 2 * card * 4
                        + nq_ * n_ * 4, nq_ * n_ * 7 * w)
    for label, b_ in (("seed", bound), ("tight", bound_t)):
        print(f"scan_verify device operations per call ({label} bound, "
              f"torch.profiler over {PROFILED_CALLS} calls):")
        _, sv_prof = device_profile(
            torch, lambda: ops.scan_verify(q, q_paas, codes_leaf, raw_leaf,
                                           b_, cfg, k=K), reps=PROFILED_CALLS)
        # the profiler may drop some calls' events, or all of them: count
        # calls by the kernel's own launches, and report nothing when it
        # saw none (a diagnostic; the launch counters are the check)
        calls = max((r[1] for r in sv_prof if "scan_verify" in r[2]),
                    default=0)
        if not calls:
            print(f"  not measured: the profiler recorded none of the "
                  f"{PROFILED_CALLS} calls' kernels")
            continue
        per_call = sum(r[1] for r in sv_prof) / calls
        print(f"  {per_call:.2f} device operations per call over {calls} "
              f"calls seen: " + "; ".join(
                  f"{r[2][:48]} {r[1] / calls:.2f}/call {1e3 * r[0] / r[1]:.2f}"
                  f" us each" for r in sv_prof))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        ops.scan_verify(q, q_paas, codes_leaf, raw_leaf, bound, cfg, k=K)
    torch.cuda.synchronize()
    print(f"scan_verify host time: {(time.perf_counter() - t0) / 200 * 1e6:.1f}"
          f" us per call (200 calls in a row, seed bound)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        ops.batch_euclid_multi(q, median_rows_t)
    torch.cuda.synchronize()
    print(f"batch_euclid host time: {(time.perf_counter() - t0) / 200 * 1e6:.1f}"
          f" us per call (200 cross-form calls in a row, Q={nq} x {nm} rows)")
    t0 = time.perf_counter()
    for r_ in cross_rows:
        ops.batch_euclid_multi(q, tree.raw[:r_])
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / len(cross_rows)
    print(f"batch_euclid host time: {host_s * 1e6:.1f} us per call (the "
          f"eager batch's {len(cross_rows)} cross-form row counts in order, "
          f"Q={nq})")
    chunk = tree.raw[:SEG_CHUNK].contiguous()      # one external-sort chunk
    nc = chunk.shape[0]
    chunks = range(0, tree.n, SEG_CHUNK)
    print(f"sax_summarize device profile (torch.profiler, the segment "
          f"build's {len(chunks)} chunks, rows resident on the card):")
    _, s_prof = device_profile(torch, lambda: [
        ops.sax_summarize(tree.raw[s:s + SEG_CHUNK], cfg) for s in chunks])
    kernel_total(s_prof, "SaxSummarize", "sax_summarize kernels",
                 "one segment build's chunks")
    c_codes = ops.sax_summarize(chunk, cfg)[1]
    pk_host = torch.from_numpy(seg_out["packed_host"]).to(dev)
    pk_hot = seg_out["packed_hot"]
    npk, pw = pk_host.shape
    for name, got, want in (
            ("mindist_batch", md, ref.mindist_batch_ref(
                q_paas, codes_leaf, lower, upper, scale)),
            ("batch_euclid", ops.batch_euclid_multi(q, verify_rows),
             ref.batch_euclid_ref(q, verify_rows)),
            ("batch_euclid_median", ops.batch_euclid_multi(q, median_rows_t),
             ref.batch_euclid_ref(q, median_rows_t)),
            ("batch_euclid_q1", ops.batch_euclid(q[0], raw_leaf),
             ref.batch_euclid_ref(q[:1], raw_leaf)[0]),
            ("batch_euclid_gather", seed_d, ref.batch_euclid_gather_ref(
                q, tree.raw, seed_idx)),
            *(("scan_verify", g, w_) for g, w_ in zip(sv, ref.scan_verify_ref(
                q, q_paas, codes_leaf, raw_leaf, lower, upper, bound,
                no_dead, scale=scale, k=K))),
            *(("scan_verify_tight", g, w_) for g, w_ in zip(
                sv_t, ref.scan_verify_ref(
                    q, q_paas, codes_leaf, raw_leaf, lower, upper, bound_t,
                    no_dead, scale=scale, k=K))),
            ("sax_summarize", ops.sax_summarize(chunk, cfg)[0],
             ref.sax_summarize_ref(chunk, bps, segments=w)[0]),
            ("zorder", ops.zorder(c_codes, cfg),
             ref.zorder_ref(c_codes, w=w, b=cfg.bits)),
            ("zorder_tree", ops.zorder(tree.codes, cfg),
             ref.zorder_ref(tree.codes, w=w, b=cfg.bits)),
            ("zorder_tree vs fused_build", ops.zorder(tree.codes, cfg),
             tree.keys),
            ("unpack_mindist", ops.mindist_batch_packed(q_paas, pk_hot, cfg),
             ref.mindist_batch_packed_ref(q_paas, pk_host, lower, upper,
                                          scale, w=w, b=cfg.bits))):
        check(torch.equal(got, want), f"{name} differs at main-path shape")
        # phase 2's ragged sweep and the main-path shapes; the tight case
        # is measured here only
        errs[name] = max(errs.get(name, 0.0), max_abs_err(torch, got, want))
    cases = {
        "mindist_batch": dict(
            source="src/repro_torch/kernels/csrc/mindist_batch.cu",
            replaces="src/repro/kernels/mindist_batch.py:70",
            shape=f"Q={nq} x N={nl} rows (one leaf), w={w}",
            fn=lambda: ops.mindist_batch(q_paas, codes_leaf, cfg),
            plain=lambda: ref.mindist_batch_ref(q_paas, codes_leaf, lower,
                                                upper, scale),
            library=None,
            bound=md_bound(nq, nl, w)),
        "batch_euclid": dict(
            source="src/repro_torch/kernels/csrc/batch_euclid.cu",
            replaces="src/repro/kernels/batch_euclid.py:45",
            shape=f"Q={nq} x N={nv} verified rows, L={L}",
            fn=lambda: ops.batch_euclid_multi(q, verify_rows),
            plain=lambda: ref.batch_euclid_ref(q, verify_rows),
            library=lambda: torch.cdist(
                q, verify_rows,
                compute_mode="donot_use_mm_for_euclid_dist").square_(),
            # the executor gathers these rows just before: warm in L2
            cold=False,
            bound=euclid_bound(nq, nv)),
        "batch_euclid_median": dict(
            source="src/repro_torch/kernels/csrc/batch_euclid.cu",
            replaces="src/repro/kernels/batch_euclid.py:45",
            shape=f"Q={nq} x N={nm} rows (the eager batch's median rows "
                  f"per cross launch), L={L}",
            launches_of="batch_euclid",
            fn=lambda: ops.batch_euclid_multi(q, median_rows_t),
            plain=lambda: ref.batch_euclid_ref(q, median_rows_t),
            library=lambda: torch.cdist(
                q, median_rows_t,
                compute_mode="donot_use_mm_for_euclid_dist").square_(),
            cold=False,
            bound=euclid_bound(nq, nm)),
        "batch_euclid_q1": dict(
            source="src/repro_torch/kernels/csrc/batch_euclid.cu",
            replaces="src/repro/kernels/batch_euclid.py:45",
            shape=f"Q=1 x N={nl} rows (ops.batch_euclid, the TPU kernel's "
                  f"own function; not on the main path), L={L}",
            launches_of="batch_euclid",
            fn=lambda: ops.batch_euclid(q[0], raw_leaf),
            plain=lambda: ref.batch_euclid_ref(q[:1], raw_leaf)[0],
            library=lambda: torch.cdist(
                q[:1], raw_leaf,
                compute_mode="donot_use_mm_for_euclid_dist").square_()[0],
            bound=euclid_bound(1, nl)),
        "batch_euclid_gather": dict(
            source="src/repro_torch/kernels/csrc/batch_euclid.cu",
            replaces="src/repro/kernels/batch_euclid.py:45",
            shape=f"Q={nq} x C={c} seed rows ({uniq} distinct), L={L}",
            fn=lambda: ops.batch_euclid_multi(q, tree.raw, idx=seed_idx),
            plain=lambda: ref.batch_euclid_gather_ref(q, tree.raw, seed_idx),
            library=None,
            bound=bound_ms(nq * L * 4 + uniq * L * 4 + nq * c * 12,
                           3 * nq * c * L)),
        "scan_verify": dict(
            source="src/repro_torch/kernels/csrc/scan_verify.cu",
            replaces="src/repro/kernels/scan_verify.py:130",
            shape=f"Q={nq} x N={nl} rows, k={K}, {live_pairs} live pairs, "
                  f"{union} live rows, {live_q} queries live",
            fn=lambda: ops.scan_verify(q, q_paas, codes_leaf, raw_leaf,
                                       bound, cfg, k=K),
            plain=lambda: ref.scan_verify_ref(
                q, q_paas, codes_leaf, raw_leaf, lower, upper, bound,
                no_dead, scale=scale, k=K),
            library=None,
            bound=sv_bound(union, live_q, live_pairs)),
        "scan_verify_tight": dict(
            source="src/repro_torch/kernels/csrc/scan_verify.cu",
            replaces="src/repro/kernels/scan_verify.py:130",
            shape=f"Q={nq} x N={nl} rows, k={K}, the batch's final k-th "
                  f"distances as bound: {live_pairs_t} live pairs, "
                  f"{union_t} live rows, {live_q_t} queries live",
            launches_of="scan_verify",
            fn=lambda: ops.scan_verify(q, q_paas, codes_leaf, raw_leaf,
                                       bound_t, cfg, k=K),
            plain=lambda: ref.scan_verify_ref(
                q, q_paas, codes_leaf, raw_leaf, lower, upper, bound_t,
                no_dead, scale=scale, k=K),
            library=None,
            bound=sv_bound(union_t, live_q_t, live_pairs_t)),
        "fused_build": dict(
            source="src/repro_torch/kernels/csrc/fused_build.cu",
            replaces="src/repro/kernels/fused_build.py:57",
            shape=f"N={tree.n} x L={L}",
            fn=lambda: ops.summarize_and_key(tree.raw, cfg),
            plain=lambda: ref.fused_build_ref(tree.raw, bps,
                                              segments=w, bits=cfg.bits),
            library=None,
            bound=bound_ms(tree.n * (L * 4 + w * 5 + cfg.n_words * 8),
                           tree.n * (L + w * (1 + cfg.bits)))),
        "sax_summarize": dict(
            source="src/repro_torch/kernels/csrc/sax_summarize.cu",
            replaces="src/repro/kernels/sax_summarize.py:47",
            shape=f"N={nc} x L={L} (one external-sort chunk)",
            fn=lambda: ops.sax_summarize(chunk, cfg),
            plain=lambda: ref.sax_summarize_ref(chunk, bps, segments=w),
            library=None,
            bound=bound_ms(nc * (L * 4 + w * 5) + (card - 1) * 4,
                           nc * (L + w * cfg.bits))),
        "zorder": dict(
            source="src/repro_torch/kernels/csrc/zorder.cu",
            replaces="src/repro/kernels/zorder.py:45",
            shape=f"N={nc} x w={w} codes -> {cfg.n_words} words",
            fn=lambda: ops.zorder(c_codes, cfg),
            plain=lambda: ref.zorder_ref(c_codes, w=w, b=cfg.bits),
            library=None,
            bound=bound_ms(nc * (w + cfg.n_words * 8), nc * w * cfg.bits)),
        "zorder_tree": dict(
            source="src/repro_torch/kernels/csrc/zorder.cu",
            replaces="src/repro/kernels/zorder.py:45",
            shape=f"N={tree.n} x w={w} codes -> {cfg.n_words} words (the "
                  f"tree's codes; not a main-path shape)",
            launches_of="zorder",
            fn=lambda: ops.zorder(tree.codes, cfg),
            plain=lambda: ref.zorder_ref(tree.codes, w=w, b=cfg.bits),
            library=None,
            bound=bound_ms(tree.n * (w + cfg.n_words * 8),
                           tree.n * w * cfg.bits)),
        "unpack_mindist": dict(
            source="src/repro_torch/kernels/csrc/unpack_mindist.cu",
            replaces="src/repro/kernels/unpack_mindist.py:83",
            shape=f"Q={nq} x N={npk} packed rows of {pw} B (one leaf "
                  f"group copied from the host)",
            fn=lambda: ops.mindist_batch_packed(q_paas, pk_host, cfg),
            plain=lambda: ref.mindist_batch_packed_ref(
                q_paas, pk_host, lower, upper, scale, w=w, b=cfg.bits),
            library=None,
            # the executor copies the rows in just before: warm in L2
            cold=False,
            bound=md_bound(nq, npk, pw)),
        "unpack_mindist_hot": dict(
            source="src/repro_torch/kernels/csrc/unpack_mindist.cu",
            replaces="src/repro/kernels/unpack_mindist.py:83",
            shape=f"Q={nq} x N={npk} packed rows of {pw} B (a hot-tier "
                  f"block resident on the card)",
            fn=lambda: ops.mindist_batch_packed(q_paas, pk_hot, cfg),
            plain=lambda: ref.mindist_batch_packed_ref(
                q_paas, pk_hot, lower, upper, scale, w=w, b=cfg.bits),
            library=None,
            bound=md_bound(nq, npk, pw)),
    }
    launches = {}
    for phase in (build_launches, eager_launches, fused_launches,
                  *seg_out["launches"].values()):
        for name, v in phase.items():
            launches[name] = launches.get(name, 0) + v
    launches["unpack_mindist_hot"] = \
        seg_out["launches"]["tiered_hot"].get("unpack_mindist", 0)
    errs["unpack_mindist_hot"] = errs["unpack_mindist"]
    # a kernel timed at a second shape (scan_verify under the batch's
    # tightest bound, the cross form at other row counts): its launches are
    # that kernel's, as the record says in launches_of
    for name, cs in cases.items():
        if "launches_of" in cs:
            launches[name] = launches.get(cs["launches_of"], 0)
    record = []
    for name, cs in cases.items():
        cold = cs.get("cold", True)
        ms = timer.ms(cs["fn"], cold=cold)
        plain = timer.ms(cs["plain"], reps=PLAIN_TIMED, cold=cold)
        lib = None if cs["library"] is None else timer.ms(cs["library"],
                                                          cold=cold)
        b_ms, b_by = cs["bound"]
        record.append({
            "name": name, "route": "cuda", "source": cs["source"],
            "replaces": cs["replaces"], "launches": launches.get(name, 0),
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            **({"launches_of": cs["launches_of"]} if "launches_of" in cs
               else {})})
        print(f"kernel {name} [{cs['shape']}, L2 "
              f"{'cold' if cold else 'warm'}]: {ms:.4f} ms (plain "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms by {b_by}, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}), launches "
              f"{launches.get(name, 0)}")

    # zorder at the chunk with the L2 as pass 1 may find it: the codes
    # sax_summarize just wrote (warm), and cold without the dirty lines
    # that the zeroing flush leaves (flushed by a read)
    zo_warm = timer.ms(lambda: ops.zorder(c_codes, cfg), cold=False)
    zo_read = timer.ms(lambda: ops.zorder(c_codes, cfg), read=True)
    print(f"kernel zorder [N={nc} x w={w}]: L2 warm {zo_warm:.4f} ms, L2 "
          f"flushed by a read {zo_read:.4f} ms")

    # ops.mindist is the Q = 1 case of mindist_batch (the single-query TPU
    # kernel's function); it is not on the main path, so it has no record
    ms1 = timer.ms(lambda: ops.mindist(q_paas[0], codes_leaf, cfg))
    plain1 = timer.ms(lambda: ref.mindist_batch_ref(
        q_paas[:1], codes_leaf, lower, upper, scale), reps=PLAIN_TIMED)
    b1, by1 = md_bound(1, nl, w)
    print(f"kernel mindist_batch at Q=1 (ops.mindist) [N={nl} rows, L2 "
          f"cold]: {ms1:.4f} ms (plain {plain1:.4f} ms, bound {b1:.4f} ms "
          f"by {by1})")

    # -- 10: the record and the result -----------------------------------------------
    print(json.dumps({"kernels": record}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
