#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port of Coconut (``src/repro_torch``).

Run from the repository root on a machine with one CUDA GPU::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each one against its plain PyTorch twin (also at the shapes the
serving index gives them: ``SummaryConfig(64, 16, 8)``, 64-row flushes,
32-row leaves, probe batches of 8), then drives the port's main
path at the paper's deployment (``configs/coconut_paper.py``: L=256, w=16,
b=8, leaf 2000) over 8,388,608 z-normalized random walks made on the card:
the Coconut-Tree build, batched exact k-NN (Q=64, k=10) through the eager
kernel chain and through the fused ``scan_verify`` kernel, single-query
parity, and a brute-force check.  Then the storage path over the same
walks: an on-disk segment bulk-loaded by external sort (``sax_summarize``
+ ``zorder`` per chunk, then a merge of the spills), its columns held
against the tree's, exact k-NN straight off the file (``unpack_mindist``
per leaf group), through the tiered leaf store, budgeted searches off the
file under two ``max_bytes`` budgets, and ``tree.load`` of the file.  Then
the streaming path: the first 7,864,320 walks as host batches of 65,536
rows through a btp Coconut-LSM (buffer 1,048,576, ratio 2; every flush
``fused_build``, every merge ``tree.merge_trees`` on the card), exact
batches over a snapshot with its buffer, whole and over a window of the
newest run and the buffer, against brute force, then a flush after which
every answer keeps its bits; at one eighth of that depth pp, tp (fed each
batch's ``sax_summarize`` summaries, so its flushes run ``zorder``) and
btp engines give the same bits, and a concurrent engine answers each
snapshot a second thread searches as brute force over the rows it could
see.  Then the durable engine: a child process (``chip_smoke.py
--durable-child DIR``, its own CUDA context) makes the same walks from
the same seed, streams the 7,864,320 rows into a btp engine over a
segment store under ``build/durable_phase/`` with the write-ahead log
fsynced on every insert, and SIGKILLs itself after its last
acknowledged insert; ``CoconutLSM.open`` gives back every row and the
streaming phase's answers bit for bit (whole and windowed, and against
brute force), again through a tiered leaf store over the committed
segments (``unpack_mindist``; a repeated probe from the result cache,
never stale after an insert and a checkpoint), then a second open, and
a concurrent engine that closes without a flush reopens with every row.
Then budgeted search on the tree (``max_leaves`` 0, 16, 256 and
unlimited; ``exact_search_budgeted``, whose whole-tree bound is
``mindist`` at Q=1), and the Coconut-Trie over the tree's 8,388,608
sorted keys with the iSAX top-down baseline over 65,536 rows.  Then the
sharded engine: the same 7,864,320 walks routed by z-order key range into
4 btp shards (each insert batch summarized on the card by
``sax_summarize`` + ``zorder``, its keys routed on the host); after a
flush the threaded fan-out and the one-launch mesh scan (the shards'
columns pinned on the card, one ``scan_verify`` launch per sub-shard,
the selected rows re-verified by the gathered ``batch_euclid``) give the
streaming phase's answers bit for bit, whole and windowed, and so again
after a forced rebalance; then a 4-shard store under
``build/sharded_phase/`` at one eighth of that depth, closed with rows
only in its write-ahead logs, reopened with the same bits threaded and
mesh, through a tiered leaf store whose segment retirements drop the
mesh engine's pinned columns, and a concurrent sharded engine whose
mid-stream mesh batch is bounded by its buffers.  Then the static
sharded tree: phase 3's walks bulk-loaded into 4 shards on the card
(``fused_build`` per shard, a sample-sort), whose exact batch gives the
eager batch's dist bits through one ``scan_verify`` launch a shard,
whose window batch equals brute force over the newest 1,048,576 rows
and whose budgeted batch, where certified, the exact answers; then
``obs``: wall-mode profiled launches (one ``kernel.<name>_ms``
observation per dispatcher call), ``torch.profiler`` ranges, a
``capture()`` trace, and a live 4-shard engine whose query log the
workload analyzer certifies against the registry and whose
``/metrics``, ``/health`` and ``/workload`` are scraped over HTTP.  Then
serving (``launch/serve.py``'s loop): ``llama3.2-1b`` at its published
width in bf16 decodes 128 steps of a 64-sequence batch (prompt 256) and
streams every step's z-normalized logit summaries into a btp LSM,
answering window-64 probe micro-batches of 8 (``fused_build`` every
flush, ``mindist_batch`` and the cross form every batch; the last batch
equal to a brute force by the plain twin); an fp32 copy's prefill +
decode equals its forward; then 32 steps through a 4-shard mesh store
under ``build/serve_phase/`` (concurrent, tiered), reopened by a second
run with every acknowledged row, a third threaded run at k 10 whose probes
read the committed segments through the tiers (``unpack_mindist``; the
last batch equal to a brute force), and a budgeted pass.  Then
training (``launch/train.py``'s ``train``): ``llama3.2-1b`` at its
published width in bf16 takes 20 AdamW steps of 8 x 1024 tokens with
remat (tokens/s, seconds a step, model-FLOP share, busy share and peak
memory printed; the loss falls); SMOKE dense and MoE steps with two
microbatches give the CPU's loss, gradients and parameters on the card;
the fault-tolerant loop restarts from a checkpoint to the uninterrupted
run's state, a checkpoint round-trips bit for bit and restores onto the
CPU; and a four-stage GPipe forward on one card equals the sequential
pass.  No kernel is on the training path.  Then the pod tooling
(``launch/sharding.py``, ``launch/mesh.py``, ``launch/dryrun.py``): the
same train step over a ``(1, 1)`` DeviceMesh on a one-rank NCCL group
(``shard_state`` and ``sh``) equals the plain step bit for bit; the dry
run's reckoning of that cell on a fake one-rank world gives its argument
bytes exactly and its peak memory within 25% of the card's; and one
production dry-run cell (``llama3.2-1b`` x ``train_4k`` over the fake
256-rank single-pod mesh) runs to exit 0.  Then
every kernel is timed at the main path's
shapes (the cross
form of ``batch_euclid`` at the densest leaf group, at the eager batch's
median rows per launch and at Q=1; ``zorder`` also over the tree's
8,388,608 rows, and at the chunk with the L2 warm and flushed by a read;
``mindist`` at Q=1 over the tree's 8,388,608 rows; ``scan_verify`` also
over one sub-shard of the mesh launch)
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
# phase 10: a stream of 7.5 buffers through a btp engine (ratio 2): runs of
# 4, 2 and 1 buffers and half a buffer still buffered
STREAM_ROWS = 7_864_320
STREAM_BATCH = 65_536
STREAM_CAPACITY = 1 << 20
STREAM_WINDOW = 1_572_864   # the newest run and the buffer
MODES_DEPTH = 8             # phase 11 runs at one eighth of phase 10's depth
BUDGET_LEAVES = (0, 16, 256, None)   # phase 12's max_leaves; None: unlimited
BUDGETED_QUERIES = 8        # exact_search_budgeted calls, budget 1024
BUDGETED_ROWS = 1024
BUDGET_BYTE_LEAVES = (16, 256)   # phase 12's max_bytes, in whole-leaf charges
# phase 13: phase 10's stream into a durable engine in a child process that
# kills itself with SIGKILL after its last acknowledged insert
DURABLE_CHILD = "--durable-child"   # the child's entry, with its store path
DURABLE_CHILD_S = 600               # the child's time limit
ISAX_ROWS = 65_536          # phase 14: rows inserted one at a time into iSAX
# phases 15-16: the sharded engine's shards, each with a quarter of phase
# 10's buffer, so the stream buffers as many rows in all
SHARDS = 4
SHARD_CAPACITY = STREAM_CAPACITY // SHARDS
# phase 17: the static sharded tree over phase 3's walks, four shards on the
# card; a window of the newest rows by timestamp, a per-shard budget
STATIC_WINDOW = 1_048_576
STATIC_BUDGET = 4096
STATIC_SINGLES = 4          # distributed_exact_search calls vs batch rows
OBS_QUERIES = 8             # phase 18's live engine: queries a batch
OBS_BATCHES = 4
OBS_LEAVES = 16             # phase 18's traced batches: max_leaves
# phase 19: the serving loop at llama3.2-1b's published width
SERVE_ARCH = "llama3.2-1b"
SERVE_BATCH = 64
SERVE_PROMPT = 256
SERVE_STEPS = 128
SERVE_BRANCH_STEPS = 32     # the sharded, reopened and budgeted runs
SERVE_ALL_WINDOW = 1 << 20  # the tiered run's window: every row it holds
SERVE_PROFILED_STEPS = 8    # the warm-up run, then the same run profiled
SERVE_FP32_T = 64           # the fp32 cache-consistency prompt
SERVE_FP32_TOL = 1e-3       # rtol = atol for prefill + decode vs forward
# phase 20: training at llama3.2-1b's published width, and the trainer's
# parts at SMOKE width
TRAIN_ARCH = "llama3.2-1b"
TRAIN_BATCH = 8
TRAIN_SEQ = 1024
TRAIN_STEPS = 20
TRAIN_TIMED_FROM = 2        # p50 over steps 3..20 (the first two warm up)
TRAIN_PROFILED_STEPS = 3
TRAIN_SMOKE_ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m")
TRAIN_SMOKE_TOL = 1e-4      # rtol = atol, card vs CPU, TF32 off
TRAIN_FAULT_STEP = 7        # the injected fault; checkpoints every 5 steps
TRAIN_RESUME_TOL = 2e-5     # the reference test's resume tolerance
PIPE_STAGES, PIPE_M, PIPE_B, PIPE_D = 4, 8, 64, 2048
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 (data sheet, 700 W)
# phase 21: the pod tooling on one card — phase 20's step sharded over a
# (1, 1) and a (1, 1, 1) DeviceMesh on NCCL, and the dry run's reckoning of it
POD_STEPS = 3               # sharded steps, then as many plain ones
POD_PEAK_TOL = 0.25         # reckoned peak vs the measured rise
POD_SUBPROCESS_S = 600      # each dry-run subprocess's time limit


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


def twin_checks(torch, err: dict):
    """(launched, same): ``launched(out)`` synchronizes, so that a fault
    shows up at its launch; ``same(name, a, b)`` records the max abs error
    of ``name`` in ``err`` and fails unless it is 0."""
    def launched(out):
        torch.cuda.synchronize()
        return out

    def same(name, a, b):
        e = max_abs_err(torch, a, b)
        err[name] = max(err.get(name, 0.0), e)
        check(e == 0, f"{name}: kernel differs from its plain twin by {e}")

    return launched, same


def kernel_phase(torch, np, S, ops, ref, pack_codes, dev) -> dict:
    """Max abs error per kernel (the tolerance is 0: kernels and twins do
    the same float operations in the same order, with no FMA)."""
    err = {}
    launched, same = twin_checks(torch, err)
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
    # the mesh launch: one scan_verify per sub-shard of [S, cap] stacks
    # with padding rows and per-shard window cuts, merged by selection,
    # against the single-device top-k over the flat stack
    i32_min = np.iinfo(np.int32).min
    for cfg in (S.SummaryConfig(64, 8, 4), S.SummaryConfig(256, 16, 8)):
        lower, upper = S.region_bounds(cfg.bits, device=dev)
        for n_sh, cap in ((1, 300), (4, 2048)):
            xt = torch.from_numpy(walks(np, rng, n_sh * cap,
                                        cfg.series_len)).to(dev)
            _, codes = S.summarize(xt, cfg)
            ids = torch.from_numpy(rng.permutation(n_sh * cap).astype(
                np.int32)).to(dev).reshape(n_sh, cap)
            ids[:, cap - 37:] = -1
            ts = torch.from_numpy(rng.integers(0, 1000, (n_sh, cap)).astype(
                np.int32)).to(dev)
            blocks = (codes.reshape(n_sh, cap, -1),
                      xt.reshape(n_sh, cap, -1), ids, ts)
            for nq in (1, 64):
                qt = torch.from_numpy(walks(np, rng, nq,
                                            cfg.series_len)).to(dev)
                q_paas = S.paa(qt, cfg.segments)
                ed = ops.batch_euclid_multi(qt, xt)
                bound = ed.median(dim=1).values
                bound[0] = float("inf")
                for cut in (None, torch.from_numpy(rng.integers(
                        0, 500, n_sh).astype(np.int32)).to(dev)):
                    for k in (1, 10):
                        got = launched(ops.mesh_scan(
                            qt, q_paas, *([b_] for b_ in blocks), cut,
                            bound, cfg, k=k))
                        tm = cut if cut is not None else torch.full(
                            (n_sh,), i32_min, dtype=torch.int32, device=dev)
                        want = ref.mesh_scan_ref(
                            qt, q_paas, *blocks, tm, bound, lower, upper,
                            scale=cfg.series_len / cfg.segments, k=k)
                        for g, w_ in zip(got, want):
                            same("mesh_scan", g, w_)
    pool_merge_sweep(torch, np, S, ops, ref, dev, rng, launched, same)
    serving_shapes(torch, np, S, ops, ref, pack_codes, dev, rng, err)
    return err


def pool_merge_sweep(torch, np, S, ops, ref, dev, rng, launched, same
                     ) -> None:
    """The exact loop's fold at its shapes: Q = 64 with one 2000-row leaf a
    group and Q <= 8 with two, k 1 and 10, over a partition of six leaves
    (the last short).  Four groups folded in turn into pools that start
    unfilled, the third the first again (every id it brings is pooled),
    the second and fourth with a dead-row mask; an external bound below the
    k-th on every fourth query.  The bound and the cross ED come from the
    kernels, half the queries are the partition's rows with noise.  After
    every fold the pools, counts and marks equal the twin's bit for bit."""
    cfg, leaf, n_leaves = S.SummaryConfig(256, 16, 8), 2000, 6
    n = n_leaves * leaf - 37
    x = torch.from_numpy(walks(np, rng, n, cfg.series_len)).to(dev)
    _, codes = S.summarize(x, cfg)
    ids = torch.from_numpy(rng.permutation(4 * n)[:n].astype(np.int64)
                           ).to(dev)
    dead = torch.from_numpy(rng.random(n) < 0.2).to(dev)
    lanes = torch.arange(leaf, device=dev)
    for nq, b_leaves in ((64, 1), (8, 2), (1, 2)):
        qt = torch.from_numpy(walks(np, rng, nq, cfg.series_len)).to(dev)
        half = nq // 2
        if half:
            rows = torch.from_numpy(rng.integers(0, n, half)).to(dev)
            qt[:half] = x[rows] + 0.1 * torch.from_numpy(walks(
                np, rng, half, cfg.series_len)).to(dev)
        q_paas = S.paa(qt, cfg.segments)
        groups = [np.sort(rng.choice(n_leaves, b_leaves, replace=False))
                  for _ in range(3)]
        groups.insert(2, groups[0])
        for k in (1, 10):
            card = dict(
                best_d=torch.full((nq, k), float("inf"), device=dev),
                best_off=torch.full((nq, k), -1, dtype=torch.int64,
                                    device=dev),
                ext=torch.full((nq,), float("inf"), device=dev),
                counts=torch.zeros(nq, dtype=torch.int64, device=dev),
                row_mark=torch.zeros(n_leaves * leaf, dtype=torch.uint8,
                                     device=dev),
                leaf_mark=torch.zeros((nq, n_leaves), dtype=torch.uint8,
                                      device=dev))
            twin = {name: t.clone() for name, t in card.items()}
            for gi, grp in enumerate(groups):
                leaves = torch.from_numpy(grp.astype(np.int64)).to(dev)
                b = (len(grp) - 1) * leaf + min(leaf,
                                                n - int(grp[-1]) * leaf)
                sel = (leaves[:, None] * leaf + lanes).reshape(-1)[:b]
                md = ops.mindist_batch(q_paas, codes[sel], cfg)
                dd = ops.batch_euclid_multi(qt, x[sel])
                if gi == 0:
                    ext = dd.median(dim=1).values
                    card["ext"][::4] = twin["ext"][::4] = ext[::4]
                cut = dead if gi % 2 else None
                launched(ops.pool_merge(md, dd, leaves, leaf, cut, ids,
                                        **card))
                ref.pool_merge_ref(md, dd, leaves, leaf, cut, ids, **twin)
                for name, t in card.items():
                    want = twin[name]
                    if t.dtype == torch.float32:
                        t, want = t.view(torch.int32), want.view(torch.int32)
                    same("pool_merge", t, want)
            check(int(twin["counts"].sum()) > 0
                  and int(twin["best_off"].min()) >= 0,
                  f"pool_merge sweep Q={nq}, k={k}: the pools never filled")


def serving_shapes(torch, np, S, ops, ref, pack_codes, dev, rng,
                   err: dict) -> None:
    """Phase 2 at the shapes phase 19's index gives the kernels: the
    serving config ``SummaryConfig(64, 16, 8)`` (the summarize tile's
    generic path), flushes of 64 rows, leaves of 32, probe micro-batches
    of 8 (and a leftover of 1), over z-normalized Gaussian rows as the
    serve loop ingests and over walks; each kernel bit for bit against
    its twin, and the storage kernels against the ones they must equal.
    Max abs errors go into ``err``."""
    launched, same = twin_checks(torch, err)
    cfg = S.SummaryConfig(64, 16, 8)
    L, w, b = cfg.series_len, cfg.segments, cfg.bits
    lower, upper = S.region_bounds(b, device=dev)
    bps = S.breakpoints(b, device=dev)
    scale = L / w

    def rows(n):
        x = rng.standard_normal((n, L))
        x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
        return x.astype(np.float32)

    for make in (rows, lambda n: walks(np, rng, n, L)):
        for n in (32, 64):
            xt = torch.from_numpy(make(n)).to(dev)
            got = launched(ops.summarize_and_key(xt, cfg))
            for g, w_ in zip(got, ref.fused_build_ref(xt, bps, segments=w,
                                                      bits=b)):
                same("fused_build", g, w_)
            paa, codes = launched(ops.sax_summarize(xt, cfg))
            r_paa, r_codes = ref.sax_summarize_ref(xt, bps, segments=w)
            same("sax_summarize", paa, r_paa)
            same("sax_summarize", codes, r_codes)
            keys = launched(ops.zorder(codes, cfg))
            same("zorder", keys, ref.zorder_ref(codes, w=w, b=b))
            for g, w_ in zip((paa, codes, keys), got):
                same("sax_summarize+zorder vs fused_build", g, w_)
            packed = torch.from_numpy(
                pack_codes(codes.cpu().numpy(), b)).to(dev)
            for nq in (1, 8):
                qt = torch.from_numpy(make(nq)).to(dev)
                q_paas = S.paa(qt, w)
                md = launched(ops.mindist_batch(q_paas, codes, cfg))
                same("mindist_batch", md, ref.mindist_batch_ref(
                    q_paas, codes, lower, upper, scale))
                same("mindist_batch",
                     launched(ops.mindist(q_paas[0], codes, cfg)), md[0])
                mp = launched(ops.mindist_batch_packed(q_paas, packed, cfg))
                same("unpack_mindist", mp, ref.mindist_batch_packed_ref(
                    q_paas, packed, lower, upper, scale, w=w, b=b))
                same("unpack_mindist vs mindist_batch", mp, md)
                ed = launched(ops.batch_euclid_multi(qt, xt))
                same("batch_euclid", ed, ref.batch_euclid_ref(qt, xt))
                idx = torch.from_numpy(rng.integers(0, n, (nq, n))).to(dev)
                same("batch_euclid_gather",
                     launched(ops.batch_euclid_multi(qt, xt, idx=idx)),
                     ref.batch_euclid_gather_ref(qt, xt, idx))
                dead = torch.from_numpy(rng.random(n) < 0.2).to(dev)
                for bound in (ed.median(dim=1).values,
                              torch.full((nq,), float("inf"), device=dev)):
                    for k in (1, 10):
                        got_s = launched(ops.scan_verify(
                            qt, q_paas, codes, xt, bound, cfg, k=k,
                            dead=dead))
                        want = ref.scan_verify_ref(
                            qt, q_paas, codes, xt, lower, upper, bound,
                            dead.to(torch.int32), scale=scale, k=k)
                        for g, w_ in zip(got_s, want):
                            same("scan_verify", g, w_)
    # the mesh launch over 4 shards of a few leaves each (ragged, with
    # padding rows), as the serving branch's 4-shard store pins them
    i32_min = np.iinfo(np.int32).min
    for n_sh, cap in ((1, 64), (4, 32), (4, 96)):
        xt = torch.from_numpy(rows(n_sh * cap)).to(dev)
        _, codes = S.summarize(xt, cfg)
        ids = torch.from_numpy(rng.permutation(n_sh * cap).astype(
            np.int32)).to(dev).reshape(n_sh, cap)
        ids[:, cap - 7:] = -1
        ts = torch.from_numpy(rng.integers(0, 200, (n_sh, cap)).astype(
            np.int32)).to(dev)
        blocks = (codes.reshape(n_sh, cap, -1), xt.reshape(n_sh, cap, -1),
                  ids, ts)
        for nq in (1, 8):
            qt = torch.from_numpy(rows(nq)).to(dev)
            q_paas = S.paa(qt, w)
            bound = ops.batch_euclid_multi(qt, xt).median(dim=1).values
            bound[0] = float("inf")
            for cut in (None, torch.from_numpy(rng.integers(
                    0, 136, n_sh).astype(np.int32)).to(dev)):
                for k in (1, 10):
                    got = launched(ops.mesh_scan(
                        qt, q_paas, *([b_] for b_ in blocks), cut, bound,
                        cfg, k=k))
                    tm = cut if cut is not None else torch.full(
                        (n_sh,), i32_min, dtype=torch.int32, device=dev)
                    want = ref.mesh_scan_ref(qt, q_paas, *blocks, tm, bound,
                                             lower, upper, scale=scale, k=k)
                    for g, w_ in zip(got, want):
                        same("mesh_scan", g, w_)


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
    """Exact k-NN over every row of ``tree`` by :func:`brute_rows`,
    reported as the tree reports (original row offsets)."""
    return brute_rows(torch, tree.raw, tree.offsets, queries, k)


def brute_rows(torch, raw, ids, queries, k):
    """Blocked plain-torch exact k-NN over the rows ``raw`` (on the card)
    reported as ``ids``: an fp32 matmul selects each block's 64 nearest
    candidates, which are re-scored with the direct diff-square-sum and
    merged (stable on ties)."""
    q = queries
    qn = (q * q).sum(1, keepdim=True)
    cand_d, cand_i = [], []
    step = 1 << 20
    for s in range(0, raw.shape[0], step):
        blk = raw[s:s + step]
        approx = qn - 2.0 * (q @ blk.T) + (blk * blk).sum(1)[None, :]
        sel = torch.topk(approx, min(64, blk.shape[0]), dim=1,
                         largest=False).indices + s
        rows = raw[sel]                                    # [Q, 64, L]
        cand_d.append(((rows - q[:, None, :]) ** 2).sum(-1))
        cand_i.append(sel)
    d = torch.cat(cand_d, 1)
    i = torch.cat(cand_i, 1)
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return (torch.gather(d, 1, order).cpu().numpy(),
            ids[torch.gather(i, 1, order)].cpu().numpy())


def brute_merge(np, answers, k):
    """One top-k from brute forces over disjoint row sets, given in id
    order (stable on ties, as :func:`brute_rows`)."""
    d = np.concatenate([a[0] for a in answers], 1)
    i = np.concatenate([a[1] for a in answers], 1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, 1), np.take_along_axis(i, order, 1)


def agrees_with_brute(np, brute, got, what: str) -> int:
    """``got`` (dists, ids) against a brute force: dists within rtol 1e-5
    (the brute force sums in torch's order, the kernels in theirs), ids
    equal but where two rows tie within that tolerance.  Returns the
    number of tie swaps."""
    (b_d, b_o), (d, o) = brute, got
    diff = b_o != o
    check(not diff.any() or np.allclose(b_d[diff], d[diff], rtol=1e-5),
          f"{what}: {int(diff.sum())} answer ids differ from brute force")
    check(np.allclose(b_d, d, rtol=1e-5),
          f"{what}: dists differ from brute force")
    return int(diff.sum())


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
    staged = sum(tm.get(s, 0.0)
                 for s in ("seed", "bound", "verify", "merge", "sync"))
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

        # -- phase 12, off this file (run here, while it exists) -------------
        out["launches"]["budget_mmap"] = budget_mmap(
            torch, np, seg, queries, tree_answer)

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


# ---------------------------------------------------------------------------
# phases 10-12: streaming ingest, window modes, budgeted search
# ---------------------------------------------------------------------------

def stable_bits(np, a, b, what: str) -> None:
    """Two answers (dists, ids) of the port's kernels: ids equal, dists
    bitwise."""
    (d1, o1), (d2, o2) = a, b
    check(np.array_equal(o1, o2), f"{what}: ids differ")
    check(np.array_equal(np.ascontiguousarray(d1, np.float32).view(np.uint32),
                         np.ascontiguousarray(d2, np.float32).view(np.uint32)),
          f"{what}: dists are not bitwise equal")


def hist_delta(h, before):
    """(count, total ms) observed by a registry histogram since ``before``."""
    return h.count - before[0], h.sum - before[1]


def streaming_phase(torch, np, x, queries) -> dict:
    """Phase 10: the first STREAM_ROWS walks, as host batches, through a
    btp engine at the paper's deployment; exact batches over a snapshot
    with its buffer, whole and windowed, against brute force; then a
    flush, after which every answer keeps its bits.  Returns the launches
    and, for phase 13, the snapshot's answers and the ingest seconds."""
    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.core import summarization as S
    from repro_torch.core.lsm import CoconutLSM
    from repro_torch.kernels import loader
    from repro_torch.obs import get_registry
    from repro_torch.query import build_plan
    cfg, leaf = INDEX, LEAF_SIZE
    n, L, dev = STREAM_ROWS, cfg.series_len, x.device
    launches = {}
    # a run holds, per row: raw, key words (int64), PAA, code, offset,
    # timestamp and id.  Resident: phase 3's walks and tree, the stream's
    # runs; the largest merge adds its concatenation and its sorted copy
    # (the last flush's merge cascade ends in one merge of every row)
    run_row = L * 4 + cfg.n_words * 8 + cfg.segments * 5 + 3 * 8
    reckoned = (N_ROWS * L * 4 + N_ROWS * run_row + n * run_row
                + 2 * n * run_row)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x_host = x[:n].cpu().numpy()
    print(f"stream: {n} x {L} walks copied to the host in "
          f"{time.perf_counter() - t0:.2f} s; reckoned device peak "
          f"{reckoned / 2**30:.1f} GiB (phase 3's walks and tree, the "
          f"stream's runs, the last merge's concatenation and output)")
    reg = get_registry()
    h_flush = reg.histogram("compact.flush_ms")
    h_merge = reg.histogram("compact.merge_ms")
    f0, m0 = (h_flush.count, h_flush.sum), (h_merge.count, h_merge.sum)
    eng = CoconutLSM(cfg, buffer_capacity=STREAM_CAPACITY, leaf_size=leaf,
                     size_ratio=2, mode="btp")
    loader.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, n, STREAM_BATCH):
        eng.insert(x_host[s:s + STREAM_BATCH])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    launches["ingest"] = dict(loader.LAUNCHES)
    sizes = [r.n for r in eng.runs]
    buffered = eng.ingest_lag()
    check(sizes == [STREAM_CAPACITY, 2 * STREAM_CAPACITY,
                    4 * STREAM_CAPACITY]
          and buffered == n - 7 * STREAM_CAPACITY,
          f"stream: runs {sizes} and {buffered} rows buffered")
    check(eng.level_histogram() == {0: 1, 1: 1, 2: 1} and eng.merges == 4,
          f"stream: levels {eng.level_histogram()}, {eng.merges} merges")
    eng.check_invariants()
    check(launches["ingest"].get("fused_build", 0) == 7,
          f"stream: flushes launched {launches['ingest']}")
    fl, fl_ms = hist_delta(h_flush, f0)
    mg, mg_ms = hist_delta(h_merge, m0)
    print(f"stream ingest: {n} rows in {n // STREAM_BATCH} batches in "
          f"{ingest_s:.3f} s ({n / ingest_s:.0f} rows/s); runs {sizes} "
          f"(levels {eng.level_histogram()}), {buffered} rows buffered; "
          f"{fl} flushes {fl_ms:.1f} ms ({fl_ms / fl:.2f} ms each, "
          f"compact.flush_ms), {mg} merges {mg_ms:.1f} ms "
          f"({mg_ms / mg:.2f} ms each, compact.merge_ms); launches "
          f"{launches['ingest']}")

    snap = eng.snapshot(include_buffer=True)
    loader.LAUNCHES.clear()
    t0 = time.perf_counter()
    d, o, info = snap.search_exact_batch(queries, k=K)
    full_s = time.perf_counter() - t0
    launches["search"] = dict(loader.LAUNCHES)
    for name in ("mindist_batch", "batch_euclid", "batch_euclid_gather",
                 "sax_summarize", "zorder"):
        check(launches["search"].get(name, 0) > 0,
              f"stream search launched no {name}: {launches['search']}")
    check(info["buffer_rows"] == buffered, f"stream: {info['buffer_rows']} "
          f"buffer rows scanned of {buffered}")
    ties = agrees_with_brute(np, brute_rows(
        torch, x[:n], torch.arange(n, device=dev), queries, K), (d, o),
        "stream search")
    from_buf = int((o >= n - buffered).sum())
    print(f"stream search (window=None, Q={N_QUERIES} k={K}): {full_s:.3f} s "
          f"per batch; equal to brute force over {n} rows ({ties} tie "
          f"swaps); {from_buf} answers from the buffer; partitions touched "
          f"{info['partitions_touched']}, leaves scanned "
          f"{info['leaves_scanned']}; launches {launches['search']}")

    ts_min = snap.clock - STREAM_WINDOW
    parts = snap._partitions()
    plan = build_plan(parts, S.paa(queries, cfg.segments).cpu().numpy(),
                      ts_min=ts_min)
    check(len(parts) == 4 and plan.n_partitions == 2,
          f"stream window: {plan.n_partitions} of {len(parts)} partitions")
    loader.LAUNCHES.clear()
    t0 = time.perf_counter()
    dw, ow, iw = snap.search_exact_batch(queries, k=K, window=STREAM_WINDOW)
    win_s = time.perf_counter() - t0
    launches["window"] = dict(loader.LAUNCHES)
    check(iw["partitions_touched"] + iw["partitions_pruned"] == 1
          and iw["buffer_rows"] == buffered,
          f"stream window: {iw['partitions_touched']} runs touched, "
          f"{iw['partitions_pruned']} pruned, {iw['buffer_rows']} buffered")
    ties = agrees_with_brute(np, brute_rows(
        torch, x[ts_min:n], torch.arange(ts_min, n, device=dev), queries, K),
        (dw, ow), "stream window")
    print(f"stream search (window={STREAM_WINDOW}): {win_s:.3f} s per "
          f"batch; 2 of 4 partitions planned (the newest run and the "
          f"buffer); equal to brute force over rows {ts_min}..{n - 1} "
          f"({ties} tie swaps)")
    del snap

    m1 = (h_merge.count, h_merge.sum)
    loader.LAUNCHES.clear()
    t0 = time.perf_counter()
    eng.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    df, of, _ = eng.search_exact_batch(queries, k=K)
    after_s = time.perf_counter() - t0
    launches["flush"] = dict(loader.LAUNCHES)
    check([r.n for r in eng.runs] == [n], f"stream: after the flush runs "
          f"{[r.n for r in eng.runs]}")
    stable_bits(np, (df, of), (d, o), "stream: post-flush search vs the "
                "snapshot with its buffer")
    mg, mg_ms = hist_delta(h_merge, m1)
    print(f"stream flush: the {buffered}-row buffer flushed and merged "
          f"into one run of {n} rows in {flush_s:.3f} s ({mg} merges, "
          f"{mg_ms:.1f} ms); search {after_s:.3f} s; every answer, the "
          f"{from_buf} that lay in the buffer too, has its ids and bits")
    print(f"stream memory: device peak {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB (reckoned {reckoned / 2**30:.1f} GiB)")
    eng.close()
    return launches, {"whole": (d, o), "window": (dw, ow),
                      "ingest_s": ingest_s}


def modes_phase(torch, np, x, queries) -> dict:
    """Phase 11: one eighth of the stream into pp, tp and btp engines
    (tp given each batch's summaries, so its flushes key with zorder):
    the same answer bits at window=None; then into a concurrent btp
    engine while a second thread searches its snapshots, each against
    brute force over the rows it could see.  Returns the launches and
    the btp engine's answers (phase 13 reopens a store at this depth)."""
    import threading
    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.core.lsm import CoconutLSM
    from repro_torch.kernels import loader, ops
    cfg, leaf = INDEX, LEAF_SIZE
    n = STREAM_ROWS // MODES_DEPTH
    cap = STREAM_CAPACITY // MODES_DEPTH
    batch = STREAM_BATCH // MODES_DEPTH
    dev = x.device
    x_host = x[:n].cpu().numpy()
    launches, answers = {}, {}
    for mode in ("pp", "tp", "btp"):
        eng = CoconutLSM(cfg, buffer_capacity=cap, leaf_size=leaf, mode=mode)
        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        for s in range(0, n, batch):
            if mode == "tp":
                eng.insert(x_host[s:s + batch],
                           summaries=ops.sax_summarize(x[s:s + batch], cfg))
            else:
                eng.insert(x_host[s:s + batch])
        eng.flush()
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        answers[mode] = eng.search_exact_batch(queries, k=K)[:2]
        search_s = time.perf_counter() - t0
        launches[mode] = dict(loader.LAUNCHES)
        print(f"modes {mode}: {n} rows in {ingest_s:.3f} s; runs "
              f"{[r.n for r in eng.runs]} ({eng.merges} merges); search "
              f"{search_s:.3f} s; launches {launches[mode]}")
        eng.close()
    flushes = -(-n // cap)
    check(launches["tp"].get("zorder", 0) >= flushes
          and "fused_build" not in launches["tp"]
          and launches["btp"].get("fused_build", 0) == flushes,
          f"modes: tp flushes must key with zorder, btp with fused_build: "
          f"{launches['tp']}, {launches['btp']}")
    for mode in ("pp", "tp"):
        stable_bits(np, answers[mode], answers["btp"],
                    f"modes: {mode} vs btp")
    ties = agrees_with_brute(np, brute_rows(
        torch, x[:n], torch.arange(n, device=dev), queries, K),
        answers["btp"], "modes")
    print(f"modes: pp, tp and btp give the same ids and dist bits, equal to "
          f"brute force over {n} rows ({ties} tie swaps)")

    eng = CoconutLSM(cfg, buffer_capacity=cap, leaf_size=leaf, mode="btp",
                     concurrent=True)
    seen, errors = [], []
    done = threading.Event()

    def searcher():
        try:
            while not done.is_set() or len(seen) < 3:
                snap = eng.snapshot()
                d, o, _ = snap.search_exact_batch(queries, k=K)
                seen.append((snap.n, d, o))
        except BaseException as e:       # re-raised on the main thread
            errors.append(e)
            done.set()

    loader.LAUNCHES.clear()
    th = threading.Thread(target=searcher)
    t0 = time.perf_counter()
    th.start()
    try:
        for s in range(0, n, batch):
            if errors:
                break
            eng.insert(x_host[s:s + batch])
    finally:
        done.set()
        th.join()
    ingest_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    eng.flush()
    check(eng.compaction_debt() == 0 and eng.ingest_lag() == 0,
          f"concurrent: debt {eng.compaction_debt()}, lag {eng.ingest_lag()}")
    final = eng.search_exact_batch(queries, k=K)[:2]
    stats = eng.ingest.snapshot()
    eng.close()
    launches["concurrent"] = dict(loader.LAUNCHES)
    stable_bits(np, final, answers["btp"], "concurrent vs synchronous btp")
    checked = 0
    for n_vis, d, o in seen:
        if n_vis == 0:
            check(np.isinf(d).all(), "concurrent: an empty snapshot answered")
            continue
        agrees_with_brute(np, brute_rows(
            torch, x[:n_vis], torch.arange(n_vis, device=dev), queries, K),
            (d, o), f"concurrent snapshot of {n_vis} rows")
        checked += 1
    check(checked > 0, "concurrent: no snapshot saw a row")
    print(f"concurrent btp: {n} rows in {ingest_s:.3f} s while a second "
          f"thread ran {len(seen)} snapshot searches (visible rows "
          f"{[v for v, _, _ in seen]}), each equal to brute force over its "
          f"rows; close() with no debt; bg flushes {stats.get('bg_flushes')}, "
          f"merges {stats.get('bg_merges')}, backpressure waits "
          f"{stats.get('backpressure_waits', 0)}; launches "
          f"{launches['concurrent']}")
    return launches, answers["btp"]


def budget_mmap(torch, np, seg, queries, exact) -> dict:
    """Phase 12, off the segment file: ``max_bytes`` budgets bound the
    bytes the leaf scan reads (``IOStats.bytes_read`` above the
    zero-budget run's, which reads only the uncharged seed probes)."""
    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.core.metrics import IOStats
    from repro_torch.kernels import loader
    from repro_torch.storage import exact_search_mmap
    proj = LEAF_SIZE * (INDEX.segments + INDEX.series_len * 4)
    loader.LAUNCHES.clear()
    io0 = IOStats()
    t0 = time.perf_counter()
    d0, _, st0 = exact_search_mmap(seg, queries, k=K, io=io0,
                                   budget={"max_bytes": 0})
    print(f"budget mmap max_bytes=0: {time.perf_counter() - t0:.3f} s; "
          f"bytes_read {io0.bytes_read} (the seed probes), scan_bytes "
          f"{st0.scan_bytes}, leaves {st0.leaves_scanned}")
    check(st0.scan_bytes == 0 and np.isfinite(d0).all(),
          "budget mmap: a zero budget scanned or lost the seeds")
    for leaves in BUDGET_BYTE_LEAVES:
        cap = leaves * proj
        io = IOStats()
        t0 = time.perf_counter()
        d, o, st = exact_search_mmap(seg, queries, k=K, io=io,
                                     budget={"max_bytes": cap})
        dt = time.perf_counter() - t0
        scan_read = io.bytes_read - io0.bytes_read
        check(st.scan_bytes <= cap and scan_read <= cap,
              f"budget mmap: max_bytes {cap}, scan_bytes {st.scan_bytes}, "
              f"leaf-scan bytes_read {scan_read}")
        check(np.all(exact[0][:, -1] * (1 + 1e-5) + 1e-4
                     >= d[:, -1] - st.gap), "budget mmap: the gap is unsound")
        print(f"budget mmap max_bytes={cap} ({leaves} leaves' charge): "
              f"{dt:.3f} s; leaf-scan bytes_read {scan_read} <= {cap} "
              f"(bytes_read {io.bytes_read} with the seeds), scan_bytes "
              f"{st.scan_bytes}, leaves {st.leaves_scanned}, gap max "
              f"{float(st.gap.max()):.4f}")
    launches = dict(loader.LAUNCHES)
    check(launches.get("unpack_mindist", 0) > 0,
          f"budget mmap launched no unpack_mindist: {launches}")
    return launches


def budget_phase(torch, np, tree, queries, exact, brute) -> dict:
    """Phase 12 on phase 3's tree: ``max_leaves`` budgets (answers never
    worse as the budget grows, the gap sound against brute force, the
    unlimited budget the exact bits with gap 0), and
    ``exact_search_budgeted`` (``mindist`` at Q = 1 over every row)."""
    from repro_torch.core import tree as T
    from repro_torch.kernels import loader
    from repro_torch.query import Budget
    e_d, e_o = exact
    b_d = brute[0]
    launches = {"budget": {}}
    prev = None
    for m in BUDGET_LEAVES:
        budget = Budget() if m is None else Budget(max_leaves=m)
        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        d, o, st = T.exact_search_batch(tree, queries, k=K, budget=budget)
        dt = time.perf_counter() - t0
        for name, v in loader.LAUNCHES.items():
            launches["budget"][name] = launches["budget"].get(name, 0) + v
        kth = d[:, -1]
        check(m is None or st.leaves_scanned <= m,
              f"budget {m}: {st.leaves_scanned} leaves scanned")
        check(prev is None or np.all(kth <= prev),
              f"budget {m}: an answer got worse as the budget grew")
        # the brute force sums in torch's order: rtol 1e-5 as in phase 7
        check(np.all(b_d[:, -1] * (1 + 1e-5) + 1e-4 >= kth - st.gap),
              f"budget {m}: the gap is unsound against brute force")
        prev = kth
        print(f"budget max_leaves={m}: {dt:.3f} s per batch; leaves "
              f"scanned {st.leaves_scanned}, scan_bytes {st.scan_bytes}, "
              f"gap max {float(st.gap.max()):.4f}, queries certified "
              f"{int((st.gap == 0).sum())}/{len(kth)}, exhausted "
              f"{st.budget_exhausted}")
    stable_bits(np, (d, o), (e_d, e_o), "unlimited budget vs exact")
    check(np.all(st.gap == 0) and st.exact, "unlimited budget: gap != 0")
    loader.LAUNCHES.clear()
    certified = []
    t0 = time.perf_counter()
    for qi in range(BUDGETED_QUERIES):
        bd, bo, cert = T.exact_search_budgeted(tree, queries[qi],
                                               budget=BUDGETED_ROWS)
        if cert:
            certified.append(qi)
            check(np.float32(bd).view(np.uint32)
                  == np.float32(e_d[qi, 0]).view(np.uint32)
                  and (bo == e_o[qi, 0] or bd == e_d[qi, 1]),
                  f"exact_search_budgeted: query {qi} certified but not "
                  f"the exact answer")
            check(np.isclose(bd, b_d[qi, 0], rtol=1e-5),
                  f"exact_search_budgeted: query {qi} vs brute force")
    dt = (time.perf_counter() - t0) / BUDGETED_QUERIES
    single = dict(loader.LAUNCHES)
    # at Q = 1 the bound kernel is the single-query TPU kernel's function
    single["mindist"] = single.pop("mindist_batch", 0)
    check(single["mindist"] == BUDGETED_QUERIES,
          f"exact_search_budgeted launched {single}")
    launches["single"] = single
    print(f"exact_search_budgeted (budget {BUDGETED_ROWS}): {dt:.4f} s per "
          f"query; certified {certified} of {BUDGETED_QUERIES}, each equal "
          f"to the exact answer and brute force; launches {single}")
    return launches

# ---------------------------------------------------------------------------
# phases 13-14: the durable engine, the Coconut-Trie
# ---------------------------------------------------------------------------

def durable_child(root: str) -> int:
    """Phase 13's writer, in a process of its own (started by
    ``durable_phase``; never a fork of the parent's CUDA context): phase
    3's walks again from SEED, the first STREAM_ROWS of them streamed into
    a btp engine over a store at ``root`` with ``wal_fsync="always"``,
    then SIGKILL right after the last acknowledged insert.  Its one line
    of JSON on stdout is what the parent reads."""
    import hashlib
    import os
    import signal

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.core.lsm import CoconutLSM
    from repro_torch.data import series
    from repro_torch.kernels import loader
    from repro_torch.obs import get_registry
    from repro_torch.storage import SegmentStore
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = make_data(torch, series, gen, N_ROWS, INDEX.series_len)
    x_host = x[:STREAM_ROWS].cpu().numpy()
    del x
    torch.cuda.empty_cache()
    fsyncs = {"calls": 0, "s": 0.0}
    real_fsync = os.fsync

    def timed_fsync(fd):
        t0 = time.perf_counter()
        real_fsync(fd)
        fsyncs["calls"] += 1
        fsyncs["s"] += time.perf_counter() - t0

    os.fsync = timed_fsync          # the WAL's and the store's, counted
    reg = get_registry()
    h_commit = reg.histogram("compact.commit_ms")
    h_flush = reg.histogram("compact.flush_ms")
    eng = CoconutLSM(INDEX, buffer_capacity=STREAM_CAPACITY,
                     leaf_size=LEAF_SIZE, size_ratio=2, mode="btp",
                     store=SegmentStore(root), wal_fsync="always")
    c0, f0 = (h_commit.count, h_commit.sum), (h_flush.count, h_flush.sum)
    loader.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, STREAM_ROWS, STREAM_BATCH):
        eng.insert(x_host[s:s + STREAM_BATCH])      # return == ack
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    commits, commit_ms = hist_delta(h_commit, c0)
    flushes, flush_ms = hist_delta(h_flush, f0)
    rec = {"ingest_s": ingest_s, "rows": STREAM_ROWS,
           "runs": [r.n for r in eng.runs], "buffered": eng.ingest_lag(),
           "clock": eng.clock, "commits": commits, "commit_ms": commit_ms,
           "flushes": flushes, "flush_ms": flush_ms,
           "fsyncs": fsyncs["calls"], "fsync_s": fsyncs["s"],
           "ingest": eng.ingest.snapshot(), "launches": dict(loader.LAUNCHES),
           "segment_bytes": eng.store.total_bytes(),
           "wal_bytes_on_disk": eng.store.wal_bytes(),
           "rows_sha256": hashlib.sha256(
               x_host[::4096].tobytes()).hexdigest()}
    print("durable child: " + json.dumps(rec), flush=True)
    os.kill(os.getpid(), signal.SIGKILL)
    return 1                        # not reached


def reopen_split(reg, before) -> str:
    """The registry's ``open.*_ms`` observed since ``before``."""
    parts = []
    for name in ("recover", "load", "replay"):
        h = reg.histogram(f"open.{name}_ms")
        parts.append(f"{name} {h.sum - before[name]:.1f} ms")
    return ", ".join(parts)


def durable_phase(torch, np, x, queries, stream, modes_answer) -> dict:
    """Phase 13: the durable engine at phase 10's scale.  A child process
    streams phase 10's rows into a store (WAL fsync "always") and is
    killed with 524,288 acknowledged rows only in the WAL; ``open`` must
    give back every row and phase 10's answers bit for bit; reopened with
    tiers, the same bits through ``unpack_mindist`` off the committed
    segments and a result cache that is never stale; checkpoint, close and
    a second open keep ``n``; a concurrent engine at phase 11's depth
    closes without a flush and reopens with every row.  The store goes at
    the end, on failure too."""
    import hashlib
    import signal

    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.core import tree as T
    from repro_torch.core.lsm import CoconutLSM
    from repro_torch.kernels import loader
    from repro_torch.obs import get_registry
    from repro_torch.storage import SegmentStore, TieredLeafStore
    from repro_torch.storage.packing import packed_code_width
    cfg, leaf = INDEX, LEAF_SIZE
    n, L, dev = STREAM_ROWS, cfg.series_len, x.device
    cap, batch = STREAM_CAPACITY, STREAM_BATCH
    buffered = n - 7 * cap
    launches = {}
    reg = get_registry()
    work = ROOT / "build" / "durable_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        # a committed row on disk: raw, packed code, PAA, key words (at
        # most), offset, timestamp, id; a WAL row: raw, timestamp, id.
        # The peak is the post-reopen flush: one run of every row written
        # beside the three it replaces, with the buffer still in the WAL
        seg_row = L * 4 + packed_code_width(cfg.segments, cfg.bits) \
            + cfg.segments * 4 + cfg.n_words * 4 + 3 * 8
        wal_row = L * 4 + 2 * 8
        n2 = n + batch
        need = ((n - buffered) + n2) * seg_row + (buffered + batch) \
            * wal_row + (1 << 30)
        du = shutil.disk_usage(work)
        print(f"durable: {du.free / 2**30:.1f} GiB free of "
              f"{du.total / 2**30:.1f} GiB on the build disk, "
              f"{need / 2**30:.1f} GiB needed at the peak")
        check(du.free >= need, f"durable: {du.free} bytes free on disk, "
                               f"{need} needed")

        # -- 13a: the kill ---------------------------------------------------
        store_dir = work / "btp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), DURABLE_CHILD,
             str(store_dir)], capture_output=True, text=True,
            timeout=DURABLE_CHILD_S)
        child_s = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("durable child: ")]
        check(proc.returncode == -signal.SIGKILL and len(lines) == 1,
              f"durable child: exit {proc.returncode}, stdout "
              f"{proc.stdout[-2000:]!r}, stderr {proc.stderr[-4000:]!r}")
        rec = json.loads(lines[0][len("durable child: "):])
        launches["kill_child"] = rec["launches"]
        check(rec["rows_sha256"] == hashlib.sha256(
            x[:n:4096].cpu().numpy().tobytes()).hexdigest(),
            "durable child: its walks differ from phase 3's")
        check(rec["runs"] == [cap, 2 * cap, 4 * cap]
              and rec["buffered"] == buffered,
              f"durable child: runs {rec['runs']}, {rec['buffered']} "
              f"buffered")
        ing = rec["ingest"]
        check(ing["wal_appends"] == n // batch
              and rec["launches"].get("fused_build", 0) == 7,
              f"durable child: {ing}, launches {rec['launches']}")
        on_disk = rec["segment_bytes"] + rec["wal_bytes_on_disk"]
        rate = n / rec["ingest_s"]
        mem_rate = n / stream["ingest_s"]
        print(f"durable ingest (child, killed by SIGKILL after its last "
              f"acked insert): {n} rows in {rec['ingest_s']:.3f} s "
              f"({rate:.0f} rows/s; phase 10 in memory {mem_rate:.0f} "
              f"rows/s, {rate / mem_rate:.3f}x); {rec['flushes']} flushes "
              f"{rec['flush_ms']:.1f} ms; {rec['commits']} commits "
              f"{rec['commit_ms']:.1f} ms ({rec['commit_ms'] / rec['commits']:.1f}"
              f" ms each, compact.commit_ms: segments written, manifest, "
              f"WAL rotated); WAL appends {ing['wal_appends']}, bytes "
              f"{ing['wal_bytes']}, rotations {ing.get('wal_rotations', 0)}; "
              f"fsyncs {rec['fsyncs']} in {rec['fsync_s']:.3f} s; on disk "
              f"at the kill {rec['segment_bytes']} B of segments + "
              f"{rec['wal_bytes_on_disk']} B of WAL = {on_disk / 2**30:.2f} "
              f"GiB; child process {child_s:.1f} s (start, walks, ingest)")

        # -- 13b: the reopen -------------------------------------------------
        before = {k_: reg.histogram(f"open.{k_}_ms").sum
                  for k_ in ("recover", "load", "replay")}
        loader.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = CoconutLSM.open(str(store_dir))
        reopen_s = time.perf_counter() - t0
        split = reopen_split(reg, before)
        sizes = [r.n for r in eng.runs]
        check(eng.n == n and eng.clock == rec["clock"] == n
              and sizes == [cap, 2 * cap, 4 * cap]
              and eng.ingest_lag() == buffered
              and eng.ingest.snapshot().get("wal_replayed_rows") == buffered
              and eng.level_histogram() == {0: 1, 1: 1, 2: 1}
              and eng.merges == 4 and eng.device.type == dev.type,
              f"reopen: n {eng.n}, clock {eng.clock}, runs {sizes}, "
              f"{eng.ingest_lag()} buffered, {eng.ingest.snapshot()}")
        print(f"durable reopen: {reopen_s:.3f} s ({split}); n {eng.n}, "
              f"clock {eng.clock}, runs {sizes} on {eng.device}, "
              f"{buffered} rows replayed from the WAL into the buffer")
        run1 = eng.runs[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cols = T.to_numpy(run1.tree)
        copy_s = time.perf_counter() - t0
        nbytes = sum(c.nbytes for c in cols.values() if c is not None)
        print(f"durable: a {run1.n}-row run's columns to the host as "
              f"write_segment copies them (pageable .cpu()): {nbytes} B in "
              f"{copy_s:.3f} s ({nbytes / copy_s / 1e9:.2f} GB/s)")
        del cols, run1
        snap = eng.snapshot(include_buffer=True)
        t0 = time.perf_counter()
        d, o, info = snap.search_exact_batch(queries, k=K)
        full_s = time.perf_counter() - t0
        stable_bits(np, (d, o), stream["whole"],
                    "reopen: whole batch vs phase 10")
        ties = agrees_with_brute(np, brute_rows(
            torch, x[:n], torch.arange(n, device=dev), queries, K), (d, o),
            "reopen: whole batch")
        t0 = time.perf_counter()
        dw, ow, iw = snap.search_exact_batch(queries, k=K,
                                             window=STREAM_WINDOW)
        win_s = time.perf_counter() - t0
        stable_bits(np, (dw, ow), stream["window"],
                    "reopen: windowed batch vs phase 10")
        ts_min = snap.clock - STREAM_WINDOW
        ties_w = agrees_with_brute(np, brute_rows(
            torch, x[ts_min:n], torch.arange(ts_min, n, device=dev),
            queries, K), (dw, ow), "reopen: windowed batch")
        launches["reopen"] = dict(loader.LAUNCHES)
        print(f"durable reopen search: whole {full_s:.3f} s, window "
              f"{win_s:.3f} s; both equal to phase 10's answers bit for "
              f"bit and to brute force ({ties} and {ties_w} tie swaps); "
              f"{info['buffer_rows']} buffer rows scanned; launches "
              f"{launches['reopen']}")
        del snap
        eng.close()

        # -- 13c: tiers over the committed segments ----------------------------
        tiers = TieredLeafStore(2 * TIER_DEVICE_BYTES,
                                device_capacity_bytes=TIER_DEVICE_BYTES,
                                promote_touches=1)
        loader.LAUNCHES.clear()
        eng = CoconutLSM.open(str(store_dir), tiers=tiers)
        check(all(r.seg_handle is not None for r in eng.runs),
              "tiers: a reopened run has no segment handle")
        t0 = time.perf_counter()
        td, to, _ = eng.snapshot(include_buffer=True).search_exact_batch(
            queries, k=K)
        tier_s = time.perf_counter() - t0
        tl = dict(loader.LAUNCHES)
        check(tl.get("unpack_mindist", 0) > 0,
              f"tiers: the batch launched no unpack_mindist: {tl}")
        stable_bits(np, (td, to), stream["whole"], "tiers: whole batch")
        hits0 = tiers.result_cache.hits
        t0 = time.perf_counter()
        snap = eng.snapshot(include_buffer=True)
        snap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rd, ro, _ = snap.search_exact_batch(queries, k=K)
        hit_s = time.perf_counter() - t0
        check(tiers.result_cache.hits == hits0 + 1,
              "tiers: the repeated probe missed the result cache")
        stable_bits(np, (rd, ro), stream["whole"], "tiers: cached batch")
        # the windowed batch, the first at that key, under the profiler:
        # unpack_mindist counted on the device
        got = []
        t0 = time.perf_counter()
        busy, t_prof = device_profile(torch, lambda: got.append(
            snap.search_exact_batch(queries, k=K, window=STREAM_WINDOW)))
        tier_w_s = time.perf_counter() - t0
        twd, two, _ = got[0]
        stable_bits(np, (twd, two), stream["window"], "tiers: windowed")
        check(any("UnpackMindist" in r[2] for r in t_prof),
              "tiers: the profiler saw no unpack_mindist kernel")
        kernel_total(t_prof, "UnpackMindist",
                     "durable tiered unpack_mindist kernels",
                     "the windowed batch")
        del snap
        launches["tiers"] = dict(loader.LAUNCHES)
        print(f"durable tiers: whole {tier_s:.3f} s (unpack_mindist "
              f"launches {tl.get('unpack_mindist', 0)}); the repeat from "
              f"the result cache {hit_s * 1e3:.3f} ms after a snapshot of "
              f"{snap_s * 1e3:.1f} ms (the buffer's rows concatenated); "
              f"window {tier_w_s:.3f} s under the profiler, device busy "
              f"{busy:.3f} ms ({100 * busy / (tier_w_s * 1e3):.2f}%); every"
              f" answer phase 10's bits; {tiers.stats()}")

        # an insert holding the queries themselves, then a checkpoint (a
        # flush and a commit): the same probe must find them, not the
        # cached answer
        new = torch.cat([x[n:n2 - N_QUERIES], queries]).cpu().numpy()
        hits1 = tiers.result_cache.hits
        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        eng.insert(new)
        eng.checkpoint()
        torch.cuda.synchronize()
        ckpt_s = time.perf_counter() - t0
        sizes = [r.n for r in eng.runs]
        check(sizes == [n2] and eng.ingest_lag() == 0,
              f"checkpoint: runs {sizes}, lag {eng.ingest_lag()}")
        t0 = time.perf_counter()
        nd, no, _ = eng.search_exact_batch(queries, k=K)
        fresh_s = time.perf_counter() - t0
        launches["checkpoint"] = dict(loader.LAUNCHES)
        check(tiers.result_cache.hits == hits1,
              "tiers: the probe after the checkpoint came from the cache")
        check((no[:, 0] == np.arange(n2 - N_QUERIES, n2)).all()
              and (nd[:, 0] == 0).all(),
              "tiers: a query inserted as a row is not its own nearest")
        ties = agrees_with_brute(np, brute_merge(np, [
            brute_rows(torch, x[:n2 - N_QUERIES],
                       torch.arange(n2 - N_QUERIES, device=dev), queries, K),
            brute_rows(torch, queries,
                       torch.arange(n2 - N_QUERIES, n2, device=dev),
                       queries, K)], K), (nd, no),
            "tiers: after the checkpoint")
        disk_peak = eng.store.total_bytes() + eng.store.wal_bytes()
        print(f"durable checkpoint: {batch} rows inserted and the "
              f"{buffered + batch}-row buffer flushed, merged into one run "
              f"of {n2} rows and committed in {ckpt_s:.3f} s; the same "
              f"probe {fresh_s:.3f} s, not from the cache, equal to brute "
              f"force over {n2} rows ({ties} tie swaps); on disk "
              f"{disk_peak / 2**30:.2f} GiB after the commit")
        eng.close()

        # -- 13d: close, then a second open keeps n ----------------------------
        before = {k_: reg.histogram(f"open.{k_}_ms").sum
                  for k_ in ("recover", "load", "replay")}
        t0 = time.perf_counter()
        eng = CoconutLSM.open(str(store_dir))
        reopen2_s = time.perf_counter() - t0
        check(eng.n == n2 and eng.ingest.snapshot().get(
            "wal_replayed_rows", 0) == 0,
            f"second open: n {eng.n}, {eng.ingest.snapshot()}")
        print(f"durable second open: {reopen2_s:.3f} s "
              f"({reopen_split(reg, before)}); n {eng.n}, nothing to "
              f"replay after the checkpoint")
        eng.close()
        del eng
        torch.cuda.empty_cache()
        shutil.rmtree(store_dir)

        # -- 13e: a concurrent engine closed without a flush -------------------
        nc = n // MODES_DEPTH
        capc, batchc = cap // MODES_DEPTH, batch // MODES_DEPTH
        cdir = work / "concurrent"
        x_host = x[:nc].cpu().numpy()
        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        eng = CoconutLSM(cfg, buffer_capacity=capc, leaf_size=leaf,
                         mode="btp", concurrent=True,
                         store=SegmentStore(str(cdir)))
        for s in range(0, nc, batchc):
            eng.insert(x_host[s:s + batchc])
        eng.close()                     # drains; no flush of the tail
        conc_s = time.perf_counter() - t0
        eng = CoconutLSM.open(str(cdir))
        cd, co, _ = eng.snapshot(include_buffer=True).search_exact_batch(
            queries, k=K)
        launches["concurrent"] = dict(loader.LAUNCHES)
        replayed = eng.ingest.snapshot().get("wal_replayed_rows", 0)
        check(eng.n == nc and replayed == nc % capc,
              f"concurrent: reopened {eng.n} rows of {nc}, {replayed} "
              f"replayed")
        stable_bits(np, (cd, co), modes_answer,
                    "concurrent: reopened vs phase 11's btp")
        print(f"durable concurrent: {nc} rows in {conc_s:.3f} s, closed "
              f"without a flush; reopened with every row (runs "
              f"{[r.n for r in eng.runs]}, {replayed} replayed), answers "
              f"phase 11's bits")
        eng.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def trie_phase(torch, np, tree) -> dict:
    """Phase 14: the Coconut-Trie over phase 3's sorted keys (leaves
    contiguous over [0, N), at most a leaf of rows, each leaf's rows sharing
    its top ``depth`` interleaved bits), then the paper's Sec. 4.2
    comparison over the first ISAX_ROWS rows: iSAX entry at a time against
    the trie over the same rows."""
    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.core import tree as T
    from repro_torch.core.metrics import IOStats
    from repro_torch.core.trie import ISaxIndex, build_trie
    from repro_torch.kernels import loader
    cfg, leaf = INDEX, LEAF_SIZE
    w, b, n = cfg.segments, cfg.bits, tree.n

    def check_trie(trie, keys, what):
        starts = np.array([lf.start for lf in trie.leaves])
        ends = np.array([lf.end for lf in trie.leaves])
        depths = np.array([lf.depth for lf in trie.leaves])
        check(starts[0] == 0 and ends[-1] == len(keys)
              and (starts[1:] == ends[:-1]).all(),
              f"{what}: leaves are not contiguous over [0, N)")
        check((ends - starts).max() <= leaf and (ends > starts).all(),
              f"{what}: a leaf holds {(ends - starts).max()} rows")
        # sorted keys: a leaf's rows share a prefix iff its first and last
        # rows do.  Common prefix = the first differing bit of the words
        diff = keys[starts] ^ keys[ends - 1]
        nz = diff != 0
        word = np.where(nz.any(1), nz.argmax(1), keys.shape[1])
        dw = diff[np.arange(len(diff)), np.minimum(word, keys.shape[1] - 1)]
        msb = np.floor(np.log2(np.maximum(dw, 1))).astype(np.int64)
        common = np.where(word < keys.shape[1], 32 * word + 31 - msb,
                          32 * keys.shape[1])
        check((common >= depths).all(),
              f"{what}: a leaf's rows do not share its top depth bits")

    loader.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keys = tree.keys.cpu().numpy()
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trie = build_trie(keys, w=w, b=b, leaf_size=leaf, io=IOStats(leaf))
    split_s = time.perf_counter() - t0
    check_trie(trie, keys, "trie")
    tree_fill = n / (tree.n_leaves * leaf)
    print(f"trie: build_trie over {n} sorted keys in {copy_s + split_s:.3f}"
          f" s (the key column to the host {copy_s:.3f} s, "
          f"{keys.nbytes} B; the range split {split_s:.3f} s); "
          f"{trie.n_leaves} leaves, {trie.internal_nodes} internal nodes, "
          f"fill {trie.fill:.4f}, depth {min(l.depth for l in trie.leaves)}"
          f"..{max(l.depth for l in trie.leaves)}; the tree "
          f"{tree.n_leaves} leaves, fill {tree_fill:.4f}")

    order = torch.argsort(tree.offsets)[:ISAX_ROWS]   # the first rows
    codes = tree.codes[order].cpu().numpy()
    sub = T.build(tree.raw[order], cfg, leaf_size=leaf)
    sub_keys = sub.keys.cpu().numpy()
    tio = IOStats(leaf)
    t0 = time.perf_counter()
    sub_trie = build_trie(sub_keys, w=w, b=b, leaf_size=leaf, io=tio)
    sub_s = time.perf_counter() - t0
    check_trie(sub_trie, sub_keys, "trie over the iSAX rows")
    isax = ISaxIndex(cfg, leaf_size=leaf, io=IOStats(leaf))
    t0 = time.perf_counter()
    isax.bulk_insert(codes)
    isax_s = time.perf_counter() - t0
    check(isax.n == ISAX_ROWS and sum(len(lf.entries) for lf in
                                      isax.leaves()) == ISAX_ROWS,
          "isax: entries lost")
    check(isax.io.random_blocks >= 2 * ISAX_ROWS,
          f"isax: {isax.io.random_blocks} random blocks")
    print(f"trie vs iSAX over the first {ISAX_ROWS} rows (paper Sec. 4.2):"
          f" iSAX top-down (host, an entry at a time) {isax_s:.3f} s, "
          f"{isax.n_leaves} leaves, fill {isax.fill:.4f}, random blocks "
          f"{isax.io.random_blocks}, sequential blocks "
          f"{isax.io.total_blocks - isax.io.random_blocks}; Coconut-Trie "
          f"{sub_s:.4f} s over the sorted keys, {sub_trie.n_leaves} leaves, "
          f"fill {sub_trie.fill:.4f}, random blocks {tio.random_blocks}, "
          f"sequential blocks {tio.total_blocks - tio.random_blocks}; the "
          f"tree {sub.n_leaves} leaves, fill "
          f"{ISAX_ROWS / (sub.n_leaves * leaf):.4f}")
    return {"trie": dict(loader.LAUNCHES)}


# ---------------------------------------------------------------------------
# phases 15-16: the sharded Coconut-LSM and the one-launch mesh scan
# ---------------------------------------------------------------------------

def counter(name: str):
    from repro_torch.obs import get_registry
    return get_registry().counter(name).value


def sharded_phase(torch, np, x, queries, stream) -> tuple:
    """Phase 15: phase 10's stream through a 4-shard btp engine
    (key-range router, a per-shard buffer of a quarter of phase 10's);
    after ``flush()`` the threaded fan-out gives phase 10's bits whole and
    windowed, equal to brute force; ``scan_mode="mesh"`` gives the same
    bits with no fallback and one ``scan_verify`` launch per sub-shard;
    ``rebalance(force=True)`` keeps every bit.  Returns the launches and
    one sub-shard's pinned columns (the ``scan_verify`` mesh-shape row)."""
    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.core import summarization as S
    from repro_torch.core.windows import window_engine
    from repro_torch.kernels import loader, ops
    cfg, leaf = INDEX, LEAF_SIZE
    n, L, dev = STREAM_ROWS, cfg.series_len, x.device
    launches = {}
    run_row = L * 4 + cfg.n_words * 8 + cfg.segments * 5 + 3 * 8
    pin_row = L * 4 + cfg.segments + 2 * 4
    print(f"sharded: reckoned device memory on top of phase 3's walks and "
          f"tree ({(N_ROWS * L * 4 + N_ROWS * run_row) / 2**30:.1f} GiB): "
          f"runs {n * run_row / 2**30:.1f} GiB, the pinned stack "
          f"{n * pin_row / 2**30:.1f} GiB and its padding to the largest "
          f"shard, the largest shard's merge")
    torch.cuda.reset_peak_memory_stats()
    x_host = x[:n].cpu().numpy()
    eng = window_engine("btp", cfg, buffer_capacity=SHARD_CAPACITY,
                        leaf_size=leaf, shards=SHARDS)
    loader.LAUNCHES.clear()
    t0 = time.perf_counter()
    for s in range(0, n, STREAM_BATCH):
        eng.insert(x_host[s:s + STREAM_BATCH])
    eng.flush()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    launches["ingest"] = dict(loader.LAUNCHES)
    del x_host
    for name in ("sax_summarize", "zorder"):
        check(launches["ingest"].get(name, 0) > 0,
              f"sharded ingest launched no {name}: {launches['ingest']}")
    check(eng.n == n and sum(eng.shard_sizes()) == n,
          f"sharded: {eng.n} rows of {n}, shards {eng.shard_sizes()}")
    eng.check_invariants()
    print(f"sharded ingest: {n} rows in {n // STREAM_BATCH} routed batches "
          f"and a flush in {ingest_s:.3f} s ({n / ingest_s:.0f} rows/s; "
          f"phase 10 {n / stream['ingest_s']:.0f}); shard sizes "
          f"{eng.shard_sizes()}, runs per shard "
          f"{[[r.n for r in s.runs] for s in eng._shard_list()]}; launches "
          f"{launches['ingest']}")

    def batch(mode, window=None):
        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        d, o, info = eng.search_exact_batch(queries, k=K, window=window,
                                            scan_mode=mode)
        torch.cuda.synchronize()
        return d, o, info, time.perf_counter() - t0, dict(loader.LAUNCHES)

    def threaded_and_mesh(tag):
        """Whole and windowed batches, threaded then mesh: phase 10's bits
        and one scan_verify launch per sub-shard, no fallback."""
        out = {}
        for window, want in ((None, stream["whole"]),
                             (STREAM_WINDOW, stream["window"])):
            d, o, info, s_t, l_t = batch("threaded", window)
            stable_bits(np, (d, o), want, f"sharded {tag} threaded "
                        f"window={window} vs phase 10")
            for name in ("mindist_batch", "batch_euclid"):
                check(l_t.get(name, 0) > 0, f"sharded {tag} threaded "
                      f"launched no {name}: {l_t}")
            fb0 = counter("query.mesh_fallbacks_total")
            dm, om, im, s_m, l_m = batch("mesh", window)
            check(im.get("scan_mode") == "mesh"
                  and counter("query.mesh_fallbacks_total") == fb0,
                  f"sharded {tag} mesh window={window} fell back")
            stable_bits(np, (dm, om), (d, o), f"sharded {tag} mesh "
                        f"window={window} vs threaded")
            check(l_m.get("scan_verify", 0) == SHARDS
                  and l_m.get("batch_euclid_gather", 0) > 0,
                  f"sharded {tag} mesh launches {l_m}")
            key = "whole" if window is None else "window"
            launches[f"{tag}_threaded_{key}"] = l_t
            launches[f"{tag}_mesh_{key}"] = l_m
            out[key] = (s_t, s_m)
            print(f"sharded {tag} window={window}: threaded {s_t:.3f} s "
                  f"(shards touched {info['shards_touched']}, pruned "
                  f"{info['shards_pruned']}, leaves scanned "
                  f"{info['leaves_scanned']}), mesh {s_m:.3f} s "
                  f"(candidates {im['candidates']}); both phase 10's bits; "
                  f"launches threaded {l_t}, mesh {l_m}")
        return out

    # the first mesh batch pins: time the pin on its own
    meng = eng._mesh_engine_get()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pinned = meng.pin(eng._snapshots()[0])
    torch.cuda.synchronize()
    pin_s = time.perf_counter() - t0
    check(pinned is not None, "sharded: the snapshot could not be pinned")
    lay = pinned.layout
    print(f"sharded pin: {lay.n_shards} shards on {lay.n_devices} device(s), "
          f"cap {lay.cap} rows (padding {lay.pad_frac:.4f}), "
          f"{pinned.nbytes / 2**30:.2f} GiB by device-to-device copies in "
          f"{pin_s:.3f} s")
    # the launch alone (4 scan_verify and the selection, no bound after
    # the flush), CUDA events: these launches are not a path's
    q_paas = S.paa(queries, cfg.segments)
    unbounded = torch.full((queries.shape[0],), float("inf"), device=dev)

    def launch():
        return ops.mesh_scan(queries, q_paas, pinned.codes, pinned.raw,
                             pinned.ids, pinned.ts, None, unbounded, cfg,
                             k=K)
    launch_ms = Timer(torch).ms(launch, reps=3, cold=False)
    print(f"sharded mesh launch: {launch_ms:.3f} ms of device time (CUDA "
          f"events, median of 3, {lay.n_shards} scan_verify launches of "
          f"{lay.cap} rows and the selection)")
    ties = agrees_with_brute(np, brute_rows(
        torch, x[:n], torch.arange(n, device=dev), queries, K),
        stream["whole"], "sharded: phase 10's answers")
    times = threaded_and_mesh("flushed")
    print(f"sharded: phase 10's answers equal brute force over {n} rows "
          f"({ties} tie swaps)")
    for mode in ("threaded", "mesh"):
        wall = times["whole"][mode == "mesh"]
        print(f"sharded {mode} device profile (torch.profiler, one whole "
              f"batch):")
        busy, prof = device_profile(
            torch, lambda: eng.search_exact_batch(queries, k=K,
                                                  scan_mode=mode))
        key = "scan_verify" if mode == "mesh" else "MindistBatch"
        if any(key in r[2] for r in prof):
            print(f"sharded {mode} device busy: {busy:.3f} ms of "
                  f"{wall * 1e3:.1f} ms wall "
                  f"({100 * busy / (wall * 1e3):.2f}%)")
        else:
            print(f"sharded {mode} device busy: not measured (the "
                  f"profiler recorded none of the batch's {key} kernels)")
        if mode == "mesh":
            kernel_total(prof, "scan_verify", "mesh launch scan_verify "
                         "kernels")
    print(f"sharded memory: device peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    # one sub-shard's pinned columns, for the scan_verify mesh-shape row
    sub = {"codes": pinned.codes[0][0].clone(),
           "raw": pinned.raw[0][0].clone(),
           "dead": (pinned.ids[0][0] < 0).clone(),
           "rows": pinned.rows[0], "cap": lay.cap}
    del pinned

    t0 = time.perf_counter()
    moved = eng.rebalance(force=True)
    torch.cuda.synchronize()
    reb_s = time.perf_counter() - t0
    check(moved, "sharded: rebalance(force=True) did not migrate")
    check(eng.n == n, f"sharded: {eng.n} rows after the rebalance")
    print(f"rebalance: migrated under re-estimated boundaries in "
          f"{reb_s:.3f} s (every run's {n} rows read back to the host, "
          f"re-routed, re-flushed); shard sizes {eng.shard_sizes()}")
    threaded_and_mesh("rebalanced")
    eng.close()
    del eng, meng
    return launches, sub


def sharded_store_phase(torch, np, x, queries, modes_answer) -> dict:
    """Phase 16: phase 11's depth into a 4-shard engine over a data
    directory (WAL fsync "always"), closed with rows only in the WALs:
    ``ShardedCoconutLSM.open`` answers phase 11's bits threaded and mesh;
    reopened with tiers, the same bits through ``unpack_mindist`` and the
    mesh engine dropping its stacks when a flush retires a segment; a
    concurrent durable sharded engine answers a mesh batch mid-stream,
    seeded by its buffers, as threaded does.  The directory goes at the
    end, on failure too."""
    from repro_torch.configs import INDEX, LEAF_SIZE
    from repro_torch.distributed import ShardedCoconutLSM
    from repro_torch.kernels import loader
    from repro_torch.storage import TieredLeafStore
    cfg, leaf = INDEX, LEAF_SIZE
    n = STREAM_ROWS // MODES_DEPTH
    cap = SHARD_CAPACITY // MODES_DEPTH
    size = STREAM_BATCH // MODES_DEPTH
    launches = {}
    work = ROOT / "build" / "sharded_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        x_host = x[:n].cpu().numpy()
        root = str(work / "store")
        eng = ShardedCoconutLSM(cfg, shards=SHARDS, buffer_capacity=cap,
                                leaf_size=leaf, data_dir=root,
                                wal_fsync="always")
        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        for s in range(0, n, size):
            eng.insert(x_host[s:s + size])
        ingest_s = time.perf_counter() - t0
        buffered = eng.ingest_lag()
        eng.close()                       # the buffered rows: WAL only
        launches["ingest"] = dict(loader.LAUNCHES)
        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        eng = ShardedCoconutLSM.open(root)
        open_s = time.perf_counter() - t0
        check(eng.n == n, f"sharded store: reopened {eng.n} rows of {n}")
        eng.flush()
        for mode in ("threaded", "mesh"):
            d, o, info = eng.search_exact_batch(queries, k=K,
                                                scan_mode=mode)
            check(info.get("scan_mode", "threaded") == mode,
                  f"sharded store: {mode} batch ran {info.get('scan_mode')}")
            stable_bits(np, (d, o), modes_answer,
                        f"sharded store: reopened {mode} vs phase 11")
        dw, ow, _ = eng.search_exact_batch(queries, k=K, window=cap)
        stable_bits(np, eng.search_exact_batch(
            queries, k=K, window=cap, scan_mode="mesh")[:2], (dw, ow),
            "sharded store: windowed mesh vs threaded")
        launches["reopen"] = dict(loader.LAUNCHES)
        eng.close()
        print(f"sharded store: {n} rows in {ingest_s:.3f} s "
              f"({n / ingest_s:.0f} rows/s, WAL fsync always), closed with "
              f"{buffered} rows only in the WALs; open {open_s:.3f} s with "
              f"every row; threaded and mesh give phase 11's bits, "
              f"windowed too; launches {launches['reopen']}")

        tiers = TieredLeafStore(1 << 30, device_capacity_bytes=1 << 28)
        loader.LAUNCHES.clear()
        eng = ShardedCoconutLSM.open(root, tiers=tiers)
        d, o, _ = eng.search_exact_batch(queries, k=K)
        stable_bits(np, (d, o), modes_answer, "sharded store: tiers")
        check(loader.LAUNCHES.get("unpack_mindist", 0) > 0,
              f"sharded store: tiers launched no unpack_mindist: "
              f"{dict(loader.LAUNCHES)}")
        m = eng.search_exact_batch(queries, k=K, scan_mode="mesh")
        stable_bits(np, m[:2], modes_answer, "sharded store: tiers mesh")
        inv0 = counter("query.mesh_invalidations_total")
        check(eng._mesh_engine.pinned is not None,
              "sharded store: nothing pinned")
        extra = x[n:n + 2 * size].cpu().numpy()
        for s in (0, size):               # the second flush merges
            eng.insert(extra[s:s + size])
            eng.flush()
        check(counter("query.mesh_invalidations_total") > inv0
              and eng._mesh_engine.pinned is None,
              "sharded store: no invalidation reached the mesh engine")
        stable_bits(np, eng.search_exact_batch(queries, k=K,
                                               scan_mode="mesh")[:2],
                    eng.search_exact_batch(queries, k=K,
                                           scan_mode="threaded")[:2],
                    "sharded store: repinned mesh vs threaded")
        launches["tiers"] = dict(loader.LAUNCHES)
        eng.close()
        print(f"sharded store tiers: phase 11's bits through unpack_mindist "
              f"({launches['tiers'].get('unpack_mindist', 0)} launches); two "
              f"inserts and flushes dropped the pinned stacks "
              f"(query.mesh_invalidations_total "
              f"{counter('query.mesh_invalidations_total') - inv0}); "
              f"repinned mesh == threaded; {tiers.stats()}")

        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        seen = 0
        with ShardedCoconutLSM(cfg, shards=SHARDS, buffer_capacity=cap,
                               leaf_size=leaf, data_dir=str(work / "conc"),
                               concurrent=True, scan_mode="mesh") as eng:
            for s in range(0, n, size):
                eng.insert(x_host[s:s + size])
                if s == n // size // 2 * size:     # mid-stream
                    m = eng.search_exact_batch(queries, k=K)
                    t = eng.search_exact_batch(queries, k=K,
                                               scan_mode="threaded")
                    check(m[2]["scan_mode"] == "mesh"
                          and m[2]["buffer_rows"] > 0,
                          f"concurrent sharded: mesh info {m[2]}")
                    stable_bits(np, m[:2], t[:2],
                                "concurrent sharded: mesh vs threaded")
                    seen = m[2]["buffer_rows"]
            eng.flush()
            stable_bits(np, eng.search_exact_batch(queries, k=K)[:2],
                        modes_answer, "concurrent sharded vs phase 11")
        conc_s = time.perf_counter() - t0
        launches["concurrent"] = dict(loader.LAUNCHES)
        print(f"sharded concurrent: {n} rows in {conc_s:.3f} s; mid-stream "
              f"mesh batch seeded by {seen} buffered rows == threaded; "
              f"after the flush phase 11's bits; launches "
              f"{launches['concurrent']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phases 17-18: the static sharded Coconut-Tree, and obs on the card
# ---------------------------------------------------------------------------

def same_rows_as(torch, np, x, queries, d, rows, want_d, want_ids,
                 what: str) -> int:
    """Sharded answers (dists ``[Q, k]``, rows ``[Q, k, L]`` on the card)
    against a tree's (dists, row ids into ``x``): dist bits equal, each
    row the gathered ED of its dist, rows equal to ``x[ids]`` but where
    two rows tie.  Returns the number of tie swaps."""
    got = d.cpu().numpy()
    check(np.array_equal(got.view(np.uint32),
                         np.ascontiguousarray(want_d).view(np.uint32)),
          f"{what}: dists are not bitwise equal")
    nq, k, L = rows.shape
    flat = rows.reshape(nq * k, L)
    slot = torch.arange(nq * k, device=rows.device).reshape(nq, k)
    from repro_torch.kernels import ops
    again = ops.batch_euclid_multi(queries, flat, idx=slot)
    check(torch.equal(again, d), f"{what}: a row is not its dist's row")
    want_rows = x[torch.from_numpy(np.ascontiguousarray(want_ids))
                  .to(x.device)]
    swaps = ~(rows == want_rows).all(-1)
    # a swapped slot holds another row at the same distance: a tie
    return int(swaps.sum())


def static_sharded_phase(torch, np, x, queries, eager) -> dict:
    """Phase 17: phase 3's walks bulk-loaded into a static sharded tree of
    four shards on the card (``fused_build`` per shard, then the
    sample-sort), timestamps 0 .. N-1.  The exact batch gives phase 4's
    dist bits through one ``scan_verify`` launch a shard; single queries
    their batch rows; a window of the newest rows its brute force; a
    per-shard budget the full answers wherever certified."""
    from repro_torch.configs import INDEX as cfg
    from repro_torch.distributed import (build_sharded,
                                         distributed_exact_search,
                                         distributed_exact_search_batch)
    from repro_torch.kernels import loader
    from repro_torch.launch.mesh import make_scan_mesh
    n, L = x.shape
    e_d, e_o = eager
    dev = x.device
    mesh = make_scan_mesh(SHARDS, devices=[dev] * SHARDS)
    check(len(mesh) == SHARDS, f"static sharded: mesh {mesh}")
    # raw, PAA, codes, keys and ts of every row, once; the sort's transients
    # (one shard's received columns in flight, the local sorts' keys and
    # permutations) are bounded by a raw shard's 2 GiB and a keys' copy
    w, nw = cfg.segments, cfg.n_words
    reckoned = n * (L * 4 + w * 4 + w + nw * 8 + 4)
    transient = (n // SHARDS) * L * 4 + n * (nw * 8 + 16)
    free, total = torch.cuda.mem_get_info()
    print(f"static sharded: reckoned {reckoned / 2**30:.2f} GiB of shards "
          f"+ {transient / 2**30:.2f} GiB of sort transients on top of "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated "
          f"({free / 2**30:.1f} GiB free of {total / 2**30:.1f})")
    check(reckoned + transient < free, "static sharded: does not fit")
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    ts = torch.arange(n, device=dev)
    loader.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = build_sharded(mesh, x, cfg, timestamps=ts)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del ts
    launches["build"] = dict(loader.LAUNCHES)
    check(launches["build"].get("fused_build", 0) == SHARDS,
          f"static sharded build: launches {launches['build']}")
    counts = tree.counts.tolist()
    check(sum(counts) == n and tree.n_valid == n
          and all(0 < c <= 2 * n // SHARDS for c in counts),
          f"static sharded: counts {counts}")
    from repro_torch.core.keys import key_less
    for j, k_ in enumerate(tree.keys):
        check(k_.device == dev and not key_less(k_[1:], k_[:-1]).any(),
              f"static sharded: shard {j} not in z-order")
        if j:
            check(not key_less(k_[:1], tree.keys[j - 1][-1:]).any(),
                  f"static sharded: shards {j - 1} and {j} overlap")
    peak = torch.cuda.max_memory_allocated()
    print(f"static sharded: build {build_s:.3f} s (4 shards on one card, "
          f"cap_factor 2); counts {counts}; global z-order; launches "
          f"{launches['build']}; device peak {peak / 2**30:.1f} GiB")

    def exact():
        return distributed_exact_search_batch(tree, queries, k=K)

    loader.LAUNCHES.clear()
    t0 = time.perf_counter()
    d, rows = exact()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches["exact"] = dict(loader.LAUNCHES)
    check(launches["exact"].get("scan_verify", 0) == SHARDS
          and launches["exact"].get("batch_euclid_gather", 0) == SHARDS,
          f"static sharded exact: launches {launches['exact']} (want "
          f"{SHARDS} scan_verify and {SHARDS} gathered re-verifies)")
    swaps = same_rows_as(torch, np, x, queries, d, rows, e_d, e_o,
                         "static sharded exact vs phase 4")
    t0 = time.perf_counter()
    d2, rows2 = exact()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(torch.equal(d2, d) and torch.equal(rows2, rows),
          "static sharded: two exact batches disagree")
    print(f"static sharded exact: Q={N_QUERIES} k={K}: {cold_s:.3f} s "
          f"first batch, {warm_s:.3f} s warm; phase 4's dist bits "
          f"({swaps} tie swaps); launches {launches['exact']}")
    busy, prof = device_profile(torch, exact)
    print(f"static sharded exact device busy (torch.profiler, one batch): "
          f"{busy:.3f} ms of {warm_s * 1e3:.1f} ms wall "
          f"({100 * busy / (warm_s * 1e3):.2f}%)")
    kernel_total(prof, "scan_verify", "static sharded scan_verify kernels")
    for qi in range(STATIC_SINGLES):
        qs = queries[qi * (N_QUERIES // STATIC_SINGLES)]
        d1, r1 = distributed_exact_search(tree, qs, k=K)
        i = qi * (N_QUERIES // STATIC_SINGLES)
        check(torch.equal(d1, d[i]) and torch.equal(r1, rows[i]),
              f"static sharded: single query {i} differs from its row")
    print(f"static sharded: distributed_exact_search == batch rows bit for "
          f"bit for {STATIC_SINGLES} queries")

    cut = n - STATIC_WINDOW
    loader.LAUNCHES.clear()
    t0 = time.perf_counter()
    dw, rw = distributed_exact_search_batch(tree, queries, k=K, ts_min=cut)
    torch.cuda.synchronize()
    win_s = time.perf_counter() - t0
    launches["window"] = dict(loader.LAUNCHES)
    check(launches["window"].get("scan_verify", 0) == SHARDS,
          f"static sharded window: launches {launches['window']}")
    b_d, b_i = brute_rows(torch, x[cut:], torch.arange(cut, n, device=dev),
                          queries, K)
    check(np.allclose(b_d, dw.cpu().numpy(), rtol=1e-5),
          "static sharded window: dists differ from brute force")
    want = x[torch.from_numpy(b_i).to(dev)]
    diff = ~(rw == want).all(-1).cpu().numpy()
    check(not diff.any() or np.allclose(b_d[diff], dw.cpu().numpy()[diff],
                                        rtol=1e-5),
          "static sharded window: rows differ from brute force")
    print(f"static sharded window: ts >= {cut} ({STATIC_WINDOW} rows) in "
          f"{win_s:.3f} s; equal to brute force over x[-{STATIC_WINDOW}:] "
          f"({int(diff.sum())} tie swaps); launches {launches['window']}")

    loader.LAUNCHES.clear()
    t0 = time.perf_counter()
    db, rb, cert = distributed_exact_search_batch(tree, queries, k=K,
                                                  budget=STATIC_BUDGET)
    torch.cuda.synchronize()
    bud_s = time.perf_counter() - t0
    launches["budget"] = dict(loader.LAUNCHES)
    check(launches["budget"].get("mindist_batch", 0) == SHARDS
          and launches["budget"].get("batch_euclid_gather", 0) == SHARDS,
          f"static sharded budget: launches {launches['budget']}")
    check(bool((db >= d).all()), "static sharded budget: beats exact")
    c = cert.cpu().numpy()
    check(np.array_equal(db.cpu().numpy()[c].view(np.uint32),
                         d.cpu().numpy()[c].view(np.uint32))
          and torch.equal(rb[cert], rows[cert]),
          "static sharded budget: a certified answer is not the exact one")
    exact_too = int((db == d).all(1).sum())
    print(f"static sharded budget: {STATIC_BUDGET} rows a shard in "
          f"{bud_s:.3f} s; {int(c.sum())} of {N_QUERIES} queries "
          f"certified, each equal to the full answer; {exact_too} answers "
          f"exact; launches {launches['budget']}")
    del tree, d, rows, d2, rows2, dw, rw, db, rb
    torch.cuda.empty_cache()
    return launches


def obs_phase(torch, np, x, tree, queries, eager, eager_s) -> dict:
    """Phase 18: ``obs`` on the card.  Wall-mode profiling around an eager
    and a fused batch on phase 3's tree (phase 4's bits; one
    ``kernel.<name>_ms`` observation per dispatcher call the script
    counts); torch mode under ``torch.profiler`` (the ``coconut.*``
    ranges) and ``capture()`` (a trace written) around a batch budgeted
    to a few leaves; profiling off, the eager batch's seconds beside
    phase 4's.  Then a 4-shard engine at phase
    11's depth with a query log under ``build/obs_phase/``: the workload
    analyzer certifies the log against the registry, the validator
    passes the tracer's export and the log, and ``ObsHTTPServer`` is
    scraped.  The directory goes at the end, on failure too."""
    import urllib.error
    import urllib.request

    from repro_torch import obs
    from repro_torch.configs import INDEX as cfg
    from repro_torch.configs import LEAF_SIZE
    from repro_torch.core import tree as T
    from repro_torch.distributed import ShardedCoconutLSM
    from repro_torch.kernels import loader, ops
    from repro_torch.obs import profile as prof
    from repro_torch.obs.analytics import WorkloadAnalyzer, iter_query_log
    from repro_torch.obs.health import HealthMonitor
    from repro_torch.obs.httpd import ObsHTTPServer, prom_name
    from repro_torch.obs.validate import validate, validate_query_log
    from repro_torch.query import Partition, exact_knn
    e_d, e_o = eager
    reg = obs.get_registry()
    part = Partition.from_tree(tree)
    launches = {}
    names = ("mindist_batch", "scan_verify")

    def batches():
        a = T.exact_search_batch(tree, queries, k=K)
        b = exact_knn([part], queries, cfg, k=K, scan_mode="kernel")
        return a, b

    def hist_counts():
        return {n_: reg.histogram(f"kernel.{n_}_ms").count for n_ in names}

    # the dispatcher calls, counted here around the profiled wrappers
    calls = dict.fromkeys(names, 0)
    wrapped = {n_: getattr(ops, n_) for n_ in names}

    def counting(n_):
        def call(*a, **kw):
            calls[n_] += 1
            return wrapped[n_](*a, **kw)
        return call

    for n_ in names:
        setattr(ops, n_, counting(n_))
    try:
        before = hist_counts()
        prof.enable_profiling("wall")
        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        (a_d, a_o, _), (f_d, f_o, _) = batches()
        wall_s = time.perf_counter() - t0
        prof.disable_profiling()
        launches["wall"] = dict(loader.LAUNCHES)
        after = hist_counts()
    finally:
        prof.disable_profiling()
        for n_ in names:
            setattr(ops, n_, wrapped[n_])
    for got_d, got_o, what in ((a_d, a_o, "eager"), (f_d, f_o, "fused")):
        check(np.array_equal(got_o, e_o)
              and np.array_equal(got_d.view(np.uint32), e_d.view(np.uint32)),
              f"obs: {what} batch under wall profiling lost phase 4's bits")
    seen = {n_: after[n_] - before[n_] for n_ in names}
    check(seen == calls and all(calls.values()),
          f"obs: kernel histograms {seen} vs dispatcher calls {calls}")
    h = {n_: reg.histogram(f"kernel.{n_}_ms") for n_ in names}
    print(f"obs wall mode: eager + fused batch {wall_s:.3f} s, phase 4's "
          f"bits; histogram counts {seen} == dispatcher calls {calls}; "
          + "; ".join(f"kernel.{n_}_ms p50 {h[n_].percentile(50):.4f} p99 "
                      f"{h[n_].percentile(99):.4f} ms" for n_ in names))

    # the traced batches are budgeted (a few leaf groups each): a whole
    # batch's trace holds thousands of launches and takes tens of seconds
    def budgeted():
        return T.exact_search_batch(tree, queries, k=K, budget=OBS_LEAVES)

    from torch.profiler import ProfilerActivity, profile
    prof.enable_profiling("torch")
    try:
        loader.LAUNCHES.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tp:
            budgeted()
            torch.cuda.synchronize()
        launches["torch"] = dict(loader.LAUNCHES)
    finally:
        prof.disable_profiling()
    ranges = {e.key: e.count for e in tp.key_averages()
              if e.key.startswith("coconut.")}
    check(ranges.get("coconut.mindist_batch", 0) > 0,
          f"obs torch mode: ranges {ranges}, launches {launches['torch']}")
    print(f"obs torch mode: record_function ranges {ranges} in a batch "
          f"budgeted to {OBS_LEAVES} leaves under torch.profiler (launches "
          f"{launches['torch']})")

    work = ROOT / "build" / "obs_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        loader.LAUNCHES.clear()
        with prof.capture(str(work / "capture")):
            budgeted()
            torch.cuda.synchronize()
        launches["capture"] = dict(loader.LAUNCHES)
        traces = list((work / "capture").glob("capture-*.json"))
        check(len(traces) == 1 and traces[0].stat().st_size > 0
              and json.loads(traces[0].read_text())["traceEvents"],
              f"obs capture: traces {traces}")
        print(f"obs capture: {traces[0].stat().st_size} B of Chrome trace "
              f"for a batch budgeted to {OBS_LEAVES} leaves")

        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        o_d, o_o, _ = T.exact_search_batch(tree, queries, k=K)
        off_s = time.perf_counter() - t0
        launches["off"] = dict(loader.LAUNCHES)
        check(np.array_equal(o_o, e_o)
              and np.array_equal(o_d.view(np.uint32), e_d.view(np.uint32)),
              "obs: eager batch with profiling off lost phase 4's bits")
        print(f"obs profiling off: eager batch {off_s:.3f} s (phase 4: "
              f"{eager_s:.3f} s)")

        # a live sharded engine, its log certified against the registry
        n = STREAM_ROWS // MODES_DEPTH
        cap = SHARD_CAPACITY // MODES_DEPTH
        size = STREAM_BATCH // MODES_DEPTH
        x_host = x[:n].cpu().numpy()
        q_host = queries[:OBS_QUERIES]
        reg.reset()
        obs.get_tracer().clear()
        obs.enable_tracing()
        log = obs.QueryLog(str(work / "qlog"))
        obs.install_query_log(log)
        ana = WorkloadAnalyzer()
        obs.add_probe_observer(ana.feed)
        mon = HealthMonitor(sources={}, events_dir=str(work / "qlog"))
        loader.LAUNCHES.clear()
        prof.enable_profiling("wall")
        try:
            t0 = time.perf_counter()
            with ShardedCoconutLSM(cfg, shards=SHARDS, buffer_capacity=cap,
                                   leaf_size=LEAF_SIZE) as eng:
                for s in range(0, n, size):
                    eng.insert(x_host[s:s + size])
                eng.flush()
                for _ in range(OBS_BATCHES):
                    eng.search_exact_batch(q_host, k=K)
            session_s = time.perf_counter() - t0
        finally:
            prof.disable_profiling()
            obs.remove_probe_observer(ana.feed)
            obs.install_query_log(None)
            log.close()
            obs.disable_tracing()
        launches["engine"] = dict(loader.LAUNCHES)
        desc = obs.describe_metrics()
        offline = WorkloadAnalyzer().feed_all(iter_query_log(
            str(work / "qlog")))
        errs = offline.check_against(desc) + ana.check_against(desc)
        check(errs == [], f"obs analytics: {errs}")
        p_ = offline.profile()
        check(p_["records"] == OBS_BATCHES and p_["complete"],
              f"obs analytics: {p_['records']} records, complete "
              f"{p_['complete']}")
        v_trace = validate(obs.get_tracer().export_chrome())
        v_log = validate_query_log(str(work / "qlog"))
        check(v_trace == [] and v_log == [],
              f"obs validate: trace {v_trace[:3]}, log {v_log[:3]}")
        print(f"obs engine: {n} rows into {SHARDS} shards and {OBS_BATCHES} "
              f"batches of {OBS_QUERIES} queries in {session_s:.3f} s under "
              f"wall profiling; the log certified against the registry "
              f"(totals {p_['totals']}); validate: trace and log clean")

        with ObsHTTPServer(0, health=mon, analyzer=ana) as srv:
            def get(path):
                try:
                    with urllib.request.urlopen(srv.url + path,
                                                timeout=30) as r:
                        return r.status, r.read().decode()
                except urllib.error.HTTPError as e:
                    return e.code, e.read().decode()
            m_status, text = get("/metrics")
            h_status, health = get("/health")
            w_status, work_doc = get("/workload")
            u_status, _ = get("/no-such-path")
        series = sorted({ln.split()[2] for ln in text.splitlines()
                         if ln.startswith("# TYPE ")
                         and ln.split()[2].startswith(prom_name("kernel."))})
        check(m_status == 200
              and prom_name("kernel.mindist_batch_ms") in series,
              f"obs scrape: /metrics {m_status}, kernel series {series}")
        check(h_status == 200, f"obs scrape: /health {h_status} {health}")
        check(w_status == 200 and json.loads(work_doc)["records"]
              == OBS_BATCHES, f"obs scrape: /workload {w_status}")
        check(u_status == 404, f"obs scrape: unknown path {u_status}")
        print(f"obs scrape: /metrics 200 ({len(text)} B; {series}), "
              f"/health 200 ({json.loads(health)['state']}), /workload 200, "
              f"unknown path 404")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches



# ---------------------------------------------------------------------------
# phase 19: serving — decode at full width feeding the streaming index
# ---------------------------------------------------------------------------

def run_serve(SV, cfg, argv, **kw):
    """``serve`` of ``cfg`` under the command line ``argv``, its printed
    lines echoed; returns (result, the lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = SV.serve(cfg, SV.build_parser().parse_args(argv), **kw)
    text = buf.getvalue()
    for ln in text.splitlines():
        print(f"  serve: {ln[:400]}")
    return out, text


def serving_phase(torch, np) -> dict:
    """``launch/serve.py``'s loop at ``llama3.2-1b``'s published width on
    the card: (a) batch 64, prompt 256, 128 decode steps into a btp LSM
    with the reference's index settings (probe micro-batches of 8 at
    window 64, k 1), the launches of its kernels counted; (b) the last
    micro-batch against a brute force by the plain twin over the rows the
    window covers; (c) fp32 prefill + one decode step against a forward
    over T + 1 tokens; (d) 32 steps through a 4-shard mesh store under
    ``build/serve_phase/`` (concurrent, tiered), again on the same
    directory, a third time threaded at k 10 with a window over every row
    (its probes read the committed segments through the tiered cache; the
    last micro-batch against a brute force), then a budgeted pass.  Short runs before (a) warm the loop
    and give the device's busy share."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.kernels import loader, ref
    from repro_torch.launch import serve as SV
    from repro_torch.models import (Model, make_prefill_step,
                                    make_serve_step, pad_cache)
    from repro_torch.obs.registry import get_registry
    dev = torch.device(DEVICE)
    cfg = get(SERVE_ARCH)
    B, T, steps = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS
    hd, V = cfg.head_dim_, cfg.vocab
    weights = 2 * cfg.param_count()
    logits_b = B * T * V * 2
    kv_b = cfg.n_layers * 2 * B * (T + steps + 1) * cfg.n_kv_heads * hd * 2
    scores_b = B * cfg.n_heads * T * T * 4
    print(f"serving: {SERVE_ARCH} at its published width ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads, kv "
          f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {V}; "
          f"{cfg.param_count() / 1e9:.2f} B params); reckoned: weights "
          f"{weights / 1e9:.2f} GB bf16, prefill logits [{B}, {T}, {V}] "
          f"{logits_b / 1e9:.2f} GB, KV cache {kv_b / 1e9:.2f} GB, "
          f"prefill scores a layer "
          f"{scores_b / 1e9:.2f} GB fp32; allocated before the phase "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(cfg, device=dev, seed=0).state_dict()
    torch.cuda.synchronize()
    print(f"serving: weights drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    launches = {}

    # -- the device's busy share: a short run to warm every path of the
    # loop (its first probe batch pays seconds of first calls), the same
    # run timed, then under torch.profiler; the profiler slows the host
    # many times over, so the share is the profiled device time over the
    # unprofiled wall
    short = ["--arch", SERVE_ARCH, "--steps", str(SERVE_PROFILED_STEPS),
             "--batch", str(B), "--prompt-len", str(T)]
    t0 = time.perf_counter()
    run_serve(SV, cfg, short, params=params)
    print(f"serving warm-up: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    run_serve(SV, cfg, short, params=params)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    busy_ms, _ = device_profile(
        torch, lambda: run_serve(SV, cfg, short, params=params), top=6)
    prof_s = time.perf_counter() - t0
    print(f"serving device busy (torch.profiler; prefill + "
          f"{SERVE_PROFILED_STEPS} steps + 1 probe batch): {busy_ms:.1f} ms "
          f"of device time over {plain_s * 1e3:.1f} ms of unprofiled wall "
          f"({100 * busy_ms / (plain_s * 1e3):.2f}%; {prof_s:.1f} s "
          f"profiled)")

    # -- (a) full-width decode into the index --------------------------------
    rows = []
    argv = ["--arch", SERVE_ARCH, "--steps", str(steps), "--batch", str(B),
            "--prompt-len", str(T)]
    loader.LAUNCHES.clear()
    t0 = time.perf_counter()
    out, _ = run_serve(SV, cfg, argv, params=params,
                       on_step=lambda s, logits, h: rows.append(h))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches["decode"] = dict(loader.LAUNCHES)
    rep = out["report"]
    for name in ("fused_build", "mindist_batch", "batch_euclid"):
        check(launches["decode"].get(name, 0) > 0,
              f"serving launched no {name}: {launches['decode']}")
    check(rep["ingest.rows_total"] == B * steps
          and rep["probe.count_total"] == steps
          and rep["probe.micro_batches_total"] == steps // 8,
          f"serving counts: {rep}")
    print(f"serving decode: {steps} steps x {B} seqs (prompt {T}) in "
          f"{out['wall_s']:.3f} s of loop ({serve_s:.3f} s with prefill "
          f"and the index's set-up): {rep['decode.throughput_tok_s']} "
          f"tok/s; {rep['ingest.rows_total']} rows ingested; "
          f"{rep['probe.count_total']} probes in "
          f"{rep['probe.micro_batches_total']} micro-batches, p50 "
          f"{rep['probe.latency_p50_ms']} ms, p99 "
          f"{rep['probe.latency_p99_ms']} ms; launches "
          f"{launches['decode']}; device peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # -- (b) the last micro-batch against brute force over the window ---------
    allrows = np.concatenate(rows)
    window = 64
    cut = allrows.shape[0] - window
    probes, d, ids = out["answers"][-1]
    win = torch.from_numpy(allrows[cut:]).to(dev)
    q = torch.from_numpy(probes).to(dev)
    ed = ref.batch_euclid_ref(q, win)
    order = torch.sort(ed, dim=1, stable=True).indices[:, :1]
    b_d = torch.gather(ed, 1, order).cpu().numpy()
    b_o = (order + cut).cpu().numpy()
    swaps = agrees_with_brute(np, (b_d, b_o), (d, ids),
                              "serving last micro-batch")
    check(np.array_equal(b_o, ids), "serving: ids differ from brute force")
    print(f"serving exact: the last micro-batch ({len(probes)} probes) "
          f"equals a brute force by the plain twin over the {window} rows "
          f"of the window (ids {ids[:, 0].tolist()}, {swaps} tie swaps, "
          f"dists within rtol 1e-5)")

    # -- (c) fp32 cache consistency at full width ------------------------------
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    m32 = Model(cfg32, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tok = torch.randint(0, V, (2, SERVE_FP32_T + 1), generator=gen,
                        device=dev)
    full, _, _ = m32.forward(tok)
    _, cache = make_prefill_step(m32)({"tokens": tok[:, :-1]})
    cache = pad_cache(m32, cache, extra=2)
    dec, _ = make_serve_step(m32)(cache, tok[:, -1:], SERVE_FP32_T)
    want, got = full[:, -1].double(), dec[:, 0].double()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-6)).max())
    check(torch.allclose(got, want, rtol=SERVE_FP32_TOL,
                         atol=SERVE_FP32_TOL),
          f"serving fp32: decode differs from forward by {err}")
    print(f"serving fp32 (TF32 off): prefill {SERVE_FP32_T} + one decode "
          f"step == a forward over {SERVE_FP32_T + 1} tokens, batch 2: max "
          f"abs err {err:.3e} (logits up to {float(want.abs().max()):.2f};"
          f" tolerance rtol = atol = {SERVE_FP32_TOL}) in "
          f"{time.perf_counter() - t0:.2f} s")
    del m32, full, cache, dec, want, got
    torch.cuda.empty_cache()

    # -- (d) sharded, mesh, durable, tiered; reopened; budgeted ----------------
    work = ROOT / "build" / "serve_phase"
    shutil.rmtree(work, ignore_errors=True)
    reg = get_registry()
    b_steps = SERVE_BRANCH_STEPS
    bargv = ["--arch", SERVE_ARCH, "--steps", str(b_steps), "--batch",
             str(B), "--prompt-len", str(T)]
    stored = []                     # every row the branch runs ingest
    keep = lambda s, logits, h: stored.append(h)      # noqa: E731
    try:
        texts = []
        loader.LAUNCHES.clear()
        for run in range(2):
            mesh0 = reg.counter("query.mesh_launches_total").value
            t0 = time.perf_counter()
            o, text = run_serve(SV, cfg, bargv + [
                "--shards", str(SHARDS), "--scan-mode", "mesh",
                "--concurrent", "--data-dir", str(work), "--cache-mb", "64"],
                params=params, on_step=keep)
            r = o["report"]
            mesh = r["query.mesh_launches_total"] - mesh0
            check(mesh > 0, f"serving run {run + 1}: no mesh launch ({r})")
            texts.append(text)
            print(f"serving sharded run {run + 1}: {time.perf_counter() - t0:.2f}"
                  f" s; {r['decode.throughput_tok_s']} tok/s, probe p50 "
                  f"{r['probe.latency_p50_ms']} ms p99 "
                  f"{r['probe.latency_p99_ms']} ms; mesh launches {mesh}, "
                  f"fallbacks {r['query.mesh_fallbacks_total']}; cache hits "
                  f"{r['cache.hits_total']}, promotions "
                  f"{r['cache.promotions_total']}")
        launches["branches"] = dict(loader.LAUNCHES)
        check("reopened" not in texts[0], "serving: run 1 reopened")
        acked = B * b_steps
        line = [ln for ln in texts[1].splitlines()
                if ln.startswith("reopened")]
        check(line and f": {acked} entries" in line[0],
              f"serving run 2 did not reopen {acked} rows: {line}")
        from repro_torch.distributed import ShardedCoconutLSM
        again = ShardedCoconutLSM.open(str(work), device=dev)
        n_all = again.n
        again.close()
        check(n_all == 2 * acked, f"serving: {n_all} rows after two runs")
        print(f"serving reopen: run 2 reopened the {acked} rows run 1 "
              f"acknowledged, and a third open finds all {n_all}; launches "
              f"{launches['branches']}")

        # a third run on the same store, threaded, from another prompt,
        # k = 10, with a window over every row: its probes reach the committed
        # segments through the tiered cache (unpack_mindist on their
        # packed codes); the last micro-batch against a brute force over
        # every row the three runs ingested
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        prompt = torch.randint(0, cfg.vocab_unpadded, (B, T), generator=gen,
                               device=dev)
        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        o, _ = run_serve(SV, cfg, bargv + [
            "--shards", str(SHARDS), "--scan-mode", "threaded",
            "--concurrent", "--data-dir", str(work), "--cache-mb", "64",
            "--knn-window", str(SERVE_ALL_WINDOW), "--knn-k", str(K)],
            params=params, prompt=prompt, on_step=keep)
        launches["tiers"] = dict(loader.LAUNCHES)
        r = o["report"]
        check(launches["tiers"].get("unpack_mindist", 0) > 0,
              f"serving tiers: no unpack_mindist launch {launches['tiers']}")
        check(r["cache.misses_total"] > 0 and r["cache.hits_total"] > 0,
              f"serving tiers: no leaf read twice through the cache ({r})")
        allrows = np.concatenate(stored)
        check(allrows.shape[0] == 3 * acked,
              f"serving tiers: {allrows.shape[0]} rows ingested")
        probes, d, ids = o["answers"][-1]
        ed = ref.batch_euclid_ref(torch.from_numpy(probes).to(dev),
                                  torch.from_numpy(allrows).to(dev))
        order = torch.sort(ed, dim=1, stable=True).indices[:, :K]
        swaps = agrees_with_brute(
            np, (torch.gather(ed, 1, order).cpu().numpy(),
                 order.cpu().numpy()), (d, ids), "serving tiers")
        print(f"serving tiers run 3: {time.perf_counter() - t0:.2f} s; "
              f"window {SERVE_ALL_WINDOW} over the {3 * acked} rows, k "
              f"{K}; the last micro-batch equals a brute force by the "
              f"plain twin "
              f"({swaps} tie swaps); cache hits {r['cache.hits_total']}, "
              f"misses {r['cache.misses_total']}, promotions "
              f"{r['cache.promotions_total']}, resident "
              f"{r['cache.resident_bytes']} B; launches "
              f"{launches['tiers']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    loader.LAUNCHES.clear()
    o, text = run_serve(SV, cfg, bargv + ["--budget-leaves", "16"],
                        params=params)
    launches["budget"] = dict(loader.LAUNCHES)
    gap = [ln for ln in text.splitlines() if "gap max=" in ln]
    check(gap, "serving budget: no gap reported")
    print(f"serving budget (--budget-leaves 16): "
          f"{gap[0][gap[0].index('gap max='):]}; probe p50 "
          f"{o['report']['probe.latency_p50_ms']} ms; launches "
          f"{launches['budget']}")
    del params
    torch.cuda.empty_cache()
    return launches

# ---------------------------------------------------------------------------
# phase 20: training — the train step at full width, the trainer's parts
# ---------------------------------------------------------------------------

def run_train(LT, cfg, argv, **kw):
    """``train`` of ``cfg`` under the command line ``argv``, its printed
    lines echoed; returns its result."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = LT.train(cfg, LT.build_parser().parse_args(argv), **kw)
    for ln in buf.getvalue().splitlines():
        print(f"  train: {ln[:400]}")
    return out


def _state_pairs(a, b, prefix=""):
    """(path, tensor of a, tensor of b) over two states of one layout."""
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _state_pairs(v, b[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v, b[k]


def training_phase(torch, np) -> dict:
    """``launch/train.py`` on the card: (a) ``llama3.2-1b`` at its
    published width in bf16, 20 steps of batch 8 x 1024 tokens with remat
    and the registry's microbatches, AdamW lr 1e-3 with 10 warmup steps
    and no checkpoint in the run: tokens/s and seconds a step (p50 of
    steps 3-20, each ending in its loss read-back), model FLOP/s and its
    share of the dense bf16 peak, the busy share of 3 profiled steps and
    the peak memory; every loss and grad norm finite, the last loss below
    the first.  (b) fp32 SMOKE dense and MoE steps with 2 microbatches and
    remat on the card and on the CPU from the same weights and batch: the
    loss, every gradient and every updated parameter at rtol = atol 1e-4.
    (c) the fault-tolerant loop at SMOKE width: a fault at step 7 with
    checkpoints every 5 steps restarts from step 5 and ends at the state
    of an uninterrupted 12-step run (2e-5); a checkpoint round-trips bit
    for bit and restores onto the CPU.  (d) ``pipeline_forward`` over four
    stages of ``tanh(x @ w)`` on one card equals the sequential pass."""
    import tempfile

    from repro_torch.configs import get
    from repro_torch.configs.registry import TRAIN_MICROBATCHES
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.kernels import loader
    from repro_torch.launch import flops as FL
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.models import (Model, init_train_state,
                                    loss_and_grads, make_train_step)
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.data.tokens import TokenPipeline
    dev = torch.device(DEVICE)
    launches = {}
    work = ROOT / "build" / "train_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        # -- (a) full width ----------------------------------------------------
        cfg = get(TRAIN_ARCH)
        B, T, V = TRAIN_BATCH, TRAIN_SEQ, cfg.vocab
        n = cfg.param_count()
        micro = TRAIN_MICROBATCHES.get(TRAIN_ARCH, 1)
        saved = cfg.n_layers * B * T * cfg.d_model * 2
        print(f"training: {TRAIN_ARCH} at its published width "
              f"({cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads, kv {cfg.n_kv_heads}, d_ff {cfg.d_ff}, "
              f"vocab {V}; {n / 1e9:.2f} B params, {cfg.param_dtype}); "
              f"batch {B} x seq {T}, remat, microbatches {micro}; "
              f"reckoned: weights {2 * n / 1e9:.1f} GB, grads "
              f"{2 * n / 1e9:.1f} GB, fp32 moments {8 * n / 1e9:.1f} GB, "
              f"remat's saved layer inputs {saved / 1e9:.2f} GB, logits "
              f"{B * T * V * 2 / 1e9:.1f} GB bf16 + "
              f"{B * T * V * 4 / 1e9:.1f} GB fp32; allocated before the "
              f"phase {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                "--batch", str(B), "--seq", str(T), "--ckpt-dir",
                str(work / "full"), "--checkpoint-every",
                str(TRAIN_STEPS + 1)]
        loader.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = run_train(LT, cfg, argv, device=dev, remat=True,
                        microbatches=micro, log_every=1)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches["full"] = dict(loader.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        rt = out["runtime"]
        check(out["report"]["final_step"] == TRAIN_STEPS
              and out["report"]["restarts"] == 0
              and out["report"]["checkpoints"] == 0,
              f"training: report {out['report']}")
        log = rt.metrics_log
        losses = [r["loss"] for r in log]
        norms = [r["grad_norm"] for r in log]
        check(len(log) == TRAIN_STEPS, f"training: {len(log)} logged steps")
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"training: a loss or grad norm is not finite: {losses} "
              f"{norms}")
        check(losses[-1] < losses[0],
              f"training: the loss did not fall: {losses}")
        secs = rt.durations[TRAIN_TIMED_FROM:]
        step_s = float(np.median(secs))
        tokens = B * T
        mflops = FL.model_flops_6nd(cfg, B, T, "train")
        sflops = FL.step_flops(cfg, B, T, "train", remat=True)
        print(f"training: {TRAIN_STEPS} steps in {run_s:.1f} s (weights "
              f"drawn, first steps included); step seconds p50 "
              f"{step_s:.4f} over steps {TRAIN_TIMED_FROM + 1}-"
              f"{TRAIN_STEPS} (min {min(secs):.4f}, max {max(secs):.4f}; "
              f"step 1 {rt.durations[0]:.2f} s, step 2 "
              f"{rt.durations[1]:.3f} s); {tokens / step_s:.0f} tokens/s")
        print(f"training: model FLOP/s (6ND, {mflops / 1e12:.1f} TFLOP a "
              f"step) {mflops / step_s / 1e12:.1f} TFLOP/s = "
              f"{100 * mflops / step_s / BF16_OPS_PER_S:.1f}% of the "
              f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s dense bf16 peak; the "
              f"executed step's analytic FLOPs (remat: 4 forwards) "
              f"{sflops / 1e12:.1f} TFLOP, {sflops / step_s / 1e12:.1f} "
              f"TFLOP/s")
        print(f"training: loss {losses[0]:.4f} -> {losses[-1]:.4f}; grad "
              f"norm {norms[0]:.3f} -> {norms[-1]:.3f}; "
              f"peak memory {peak / 2**30:.1f} GiB "
              f"({(peak - before) / 2**30:.1f} GiB above the "
              f"{before / 2**30:.1f} GiB allocated before); launches "
              f"{launches['full']}")
        check(not launches["full"], "training launched a kernel: "
              f"{launches['full']}")
        step, data, state = out["train_step"], out["data"], rt.state
        batches = [data(s) for s in range(TRAIN_PROFILED_STEPS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b_ in batches:
            state, m_ = step(state, b_)
        float(m_["loss"])
        plain_s = time.perf_counter() - t0
        busy_ms, _ = device_profile(
            torch, lambda: [step(state, b_) for b_ in batches], top=8)
        print(f"training device busy (torch.profiler, "
              f"{TRAIN_PROFILED_STEPS} steps): {busy_ms:.1f} ms of device "
              f"time over {plain_s * 1e3:.1f} ms of unprofiled wall "
              f"({100 * busy_ms / (plain_s * 1e3):.2f}%)")
        del out, rt, step, data, state, batches, m_
        torch.cuda.empty_cache()

        # -- (b) card vs CPU at SMOKE width ------------------------------------
        for arch in TRAIN_SMOKE_ARCHS:
            scfg = get(arch, smoke=True)
            cpu_model = Model(scfg, device="cpu", seed=0)
            card_model = Model(scfg, device=dev, params={
                k: v.detach().clone() for k, v in
                cpu_model.state_dict().items()})
            pipe = TokenPipeline(scfg.vocab_unpadded, 4, 32, seed=3,
                                 device="cpu")
            batch = pipe(0)
            res = []
            for model, where in ((cpu_model, "cpu"), (card_model, dev)):
                st = init_train_state(model)
                b_ = {k: v.to(where) for k, v in batch.items()}
                loss, parts, grads = loss_and_grads(
                    model, st["params"], b_, microbatches=2, remat=True)
                step = make_train_step(model, microbatches=2, remat=True)
                st, met = step(st, b_)
                res.append((loss, parts, grads, st, met))
            (lc, pc, gc, sc, mc), (lg, pg, gg, sg, mg) = res
            worst = {}

            def close(a, b, what):
                a, b = a.detach().cpu(), b.detach().cpu()
                check(torch.allclose(b, a, rtol=TRAIN_SMOKE_TOL,
                                     atol=TRAIN_SMOKE_TOL),
                      f"training {arch}: {what} card vs CPU: max abs err "
                      f"{float((a - b).abs().max())}")
                kind = what.split(" ")[0]
                worst[kind] = max(worst.get(kind, 0.0),
                                  float((a - b).abs().max()))

            close(lc, lg, "loss")
            for k in pc:
                close(pc[k], pg[k], f"loss {k}")
            for k in gc:
                close(gc[k], gg[k], f"grad {k}")
            for k in sc["params"]:
                close(sc["params"][k], sg["params"][k], f"param {k}")
            close(mc["grad_norm"], mg["grad_norm"], "loss grad_norm")
            print(f"training {arch} (SMOKE, fp32, microbatches 2, remat): "
                  f"card equals CPU: loss {float(lg):.6f}, "
                  f"{len(gc)} gradients and parameters; max abs err "
                  f"{worst}")

        # -- (c) the fault-tolerant loop ---------------------------------------
        scfg = get(TRAIN_ARCH, smoke=True)
        base = ["--arch", TRAIN_ARCH, "--steps", "12", "--batch", "4",
                "--seq", "16"]

        def uninterrupted(tag):
            return run_train(LT, scfg, base + [
                "--ckpt-dir", str(work / tag), "--checkpoint-every", "100"],
                device=dev)["runtime"].state

        ref_a, ref_b = uninterrupted("plain_a"), uninterrupted("plain_b")
        bitwise = all(torch.equal(a, b) for _, a, b in
                      _state_pairs(ref_a, ref_b))
        print(f"training fault loop: two uninterrupted 12-step runs "
              f"{'are' if bitwise else 'are NOT'} bit for bit equal")
        det = not bitwise
        if det:
            # the scatter-adds of the backward (embedding, gathers) use
            # atomics; this part alone runs their deterministic versions
            torch.use_deterministic_algorithms(True, warn_only=True)
            ref_a = uninterrupted("plain_det")
        try:
            crashed = []

            def fault(s):
                if s == TRAIN_FAULT_STEP and not crashed:
                    crashed.append(s)
                    raise RuntimeError(f"injected fault at {s}")

            o = run_train(LT, scfg, base + [
                "--ckpt-dir", str(work / "fault"), "--checkpoint-every", "5"],
                device=dev, fault_hook=fault)
        finally:
            if det:
                torch.use_deterministic_algorithms(False)
        rep = o["report"]
        check(rep["final_step"] == 12 and rep["restarts"] == 1
              and rep["checkpoints"] >= 2, f"training fault loop: {rep}")
        mgr = o["runtime"].ckpt
        check(mgr.steps()[-1] == 10 and 5 in mgr.steps(),
              f"training fault loop: checkpoints {mgr.steps()}")
        got = o["runtime"].state
        err = 0.0
        for k, a, b in _state_pairs(ref_a, got):
            a32, b32 = a.detach().double(), b.detach().double()
            check(torch.allclose(b32, a32, rtol=TRAIN_RESUME_TOL,
                                 atol=TRAIN_RESUME_TOL),
                  f"training fault loop: {k} differs from the "
                  f"uninterrupted run")
            err = max(err, float((a32 - b32).abs().max()))
        same = all(torch.equal(a, b) for _, a, b in _state_pairs(ref_a, got))
        ck = CheckpointManager(work / "roundtrip", async_save=False)
        ck.save(12, got)
        back, at = ck.restore(got)
        check(at == 12 and all(torch.equal(a, b) and a.device == b.device
                               for _, a, b in _state_pairs(got, back)),
              "training: the checkpoint round trip is not bit for bit")
        host, _ = ck.restore(got, device="cpu")
        check(all(b.device.type == "cpu" and torch.equal(a.cpu(), b)
                  for _, a, b in _state_pairs(got, host)),
              "training: restore(device='cpu') differs")
        print(f"training fault loop: a fault at step {TRAIN_FAULT_STEP}, "
              f"restarted from step 5, ended at step 12 with the "
              f"uninterrupted run's state (max abs err {err:.3g}, "
              f"{'bit for bit' if same else 'not bit for bit'}"
              f"{', deterministic algorithms' if det else ''}); report "
              f"{rep}; a checkpoint round-trips bit for bit and restores "
              f"onto the CPU")

        # -- (d) the GPipe forward ---------------------------------------------
        gen = torch.Generator(device=dev).manual_seed(SEED)
        S, M, PB, D = PIPE_STAGES, PIPE_M, PIPE_B, PIPE_D
        W = torch.randn((S, D, D), generator=gen, device=dev) * D ** -0.5
        xs = torch.randn((M, PB, D), generator=gen, device=dev)
        mesh = make_stage_mesh(S)
        check(len(mesh) == S and len(set(mesh)) == 1
              and mesh[0].type == "cuda", f"stage mesh {mesh}")

        def stage(w, x):
            return torch.tanh(x @ w)

        t0 = time.perf_counter()
        y = pipeline_forward(mesh, stage, S)(W, xs)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        want = xs
        for s_ in range(S):
            want = stage(W[s_], want)
        check(torch.allclose(y, want, rtol=1e-5, atol=1e-5),
              f"pipeline: max abs err {float((y - want).abs().max())}")
        print(f"training pipeline: {S} stages over {mesh}, M={M} "
              f"microbatches of [{PB}, {D}] fp32 in {M + S - 1} ticks "
              f"({pipe_s * 1e3:.1f} ms, first call) equal the sequential "
              f"pass (max abs err {float((y - want).abs().max()):.3g})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 21: the pod tooling — a sharded train step, the dry run vs the card
# ---------------------------------------------------------------------------

POD_RECKON = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_host_mesh
D.init_fake_world(1)
r = D.run_cell(sys.argv[2], "chip_train", "host", save=False, verbose=True,
               spec=ShapeSpec("chip_train", int(sys.argv[3]),
                              int(sys.argv[4]), "train"),
               mesh=make_host_mesh(device_type="cuda"))
print("RECKONED " + json.dumps(r))
"""


def profiled_step(torch, fn):
    """(device ms, wall s) of one run of ``fn`` under torch.profiler, the
    wall the run's own, synchronized before and after: its busy share is
    the one over the other."""
    wall = []

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)

    ms, _ = device_profile(torch, run, top=0)
    return ms, wall[0]


def pod_phase(torch, np) -> dict:
    """``launch/sharding.py``, ``launch/mesh.py`` and ``launch/dryrun.py``
    on the card.  (a) Phase 20's step (``llama3.2-1b`` at its published
    width in bf16, batch 8 x 1024, remat, the registry's microbatches, the
    launcher's AdamW and token stream) over a ``(1, 1)`` mesh of
    ``make_host_mesh``'s shape on a one-rank NCCL group: ``shard_state``
    and ``sh`` (every placement falls to ``Replicate`` on one device), 3
    steps, then 3 plain steps from the same seed and batches; the losses
    and every parameter equal bit for bit; seconds a step of both (the
    difference is DTensor's dispatch), the busy share of one step of
    each, the peak memory's rise over the plain steps; then the same
    steps over a ``(1, 1, 1)`` ``("pod", "data", "model")`` mesh, which
    ``make_pod_mesh`` lays out with ``("pod", "data")`` one dim, bit for
    bit too.  (b) The dry run's
    reckoning of the same cell on a fake one-rank world in a subprocess:
    argument bytes equal the live state's and batch's bytes exactly, the
    reckoned peak within 25% of the measured rise, the traced FLOPs
    beside ``launch/flops.step_flops``.  (c) One production cell at full
    width, ``python -m repro_torch.launch.dryrun --arch llama3.2-1b
    --shape train_4k --mesh single``, exit 0.  No kernel is on this path.
    (b) and (c) trace on the meta device, on the CPU, beside (a)."""
    import os
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, \
        distribute_tensor

    from repro_torch.configs import get
    from repro_torch.configs.registry import TRAIN_MICROBATCHES
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import flops as FL
    from repro_torch.launch.mesh import make_host_mesh, make_pod_mesh
    from repro_torch.launch.sharding import (batch_placements,
                                             make_shardings, shard_state)
    from repro_torch.models import Model, init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamWConfig
    dev = torch.device(DEVICE)
    arch, B, T = TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ
    work = ROOT / "build" / "pod_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    reckon = subprocess.Popen(
        [sys.executable, "-c", POD_RECKON, str(ROOT / "src"), arch, str(T),
         str(B)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    cell = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "train_4k", "--mesh", "single"], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cfg = get(arch)
        micro = TRAIN_MICROBATCHES.get(arch, 1)
        opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
        data = TokenPipeline(cfg.vocab_unpadded, batch=B, seq_len=T,
                             d_model=cfg.d_model, device=dev)
        batches = [data(s) for s in range(POD_STEPS)]
        batch_bytes = sum(v.nbytes for v in batches[0].values())
        dist.init_process_group("nccl", init_method=f"file://{work / 'store'}",
                                rank=0, world_size=1)

        def sharded_steps(mesh, profile: bool):
            """POD_STEPS + 1 steps of the cell over ``mesh`` (the last on
            the last batch again, profiled or not): (losses, seconds a
            step, the parameters after, the state's bytes, the profiled
            step's device ms and wall s)."""
            torch.cuda.empty_cache()
            model = Model(cfg, device=dev, seed=0)
            state = shard_state(init_train_state(model, opt), mesh)
            check(all(isinstance(t, DTensor) and t.device_mesh == mesh
                      and all(isinstance(p, Replicate) for p in t.placements)
                      for t in (*state["params"].values(),
                                *state["opt"]["m"].values())),
                  f"pod: a placement on the {tuple(mesh.shape)} mesh is not "
                  f"Replicate")
            live = sum(t.to_local().nbytes for t in (
                *state["params"].values(), *state["opt"]["m"].values(),
                *state["opt"]["v"].values(), state["opt"]["step"]))
            step = make_train_step(model, sh=make_shardings(mesh),
                                   opt_cfg=opt, remat=True,
                                   microbatches=micro)
            pl = batch_placements(mesh, batches[0], B)

            def placed(b_):
                return {k: distribute_tensor(v, mesh, pl[k])
                        for k, v in b_.items()}

            losses, secs = [], []
            for b_ in batches:
                b_ = placed(b_)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, m_ = step(state, b_)
                losses.append(m_["loss"].full_tensor().item())
                secs.append(time.perf_counter() - t1)
            # a fourth step on the last batch (so too the plain side): the
            # parameters are compared after it
            b_ = placed(batches[-1])
            busy, wall = (profiled_step(torch, lambda: step(state, b_))
                          if profile else (None, None))
            if not profile:
                step(state, b_)
            params = {k: v.to_local().detach()
                      for k, v in state["params"].items()}
            return losses, secs, params, live, busy, wall

        try:
            mesh = make_host_mesh(device_type="cuda")
            check(tuple(mesh.shape) == (1, 1)
                  and mesh.device_type == "cuda", f"pod: mesh {mesh}")
            s_losses, s_secs, sharded, live_bytes, s_busy, s_wall = \
                sharded_steps(mesh, profile=True)
            torch.cuda.empty_cache()
            # the multi-pod mesh's three axes, one device each, laid out
            # with ("pod", "data") as one dim
            pod_mesh = make_pod_mesh((1, 1, 1), ("pod", "data", "model"),
                                     "cuda")
            check(tuple(pod_mesh.mesh_dim_names) == ("pod+data", "model"),
                  "pod: the (1, 1, 1) mesh's dims")
            t1 = time.perf_counter()
            p3_losses, p3_secs, pod3, live3, _, _ = sharded_steps(
                pod_mesh, profile=False)
            p3_run = time.perf_counter() - t1
            check(live3 == live_bytes, f"pod: the (1, 1, 1) state holds "
                  f"{live3} B, the (1, 1) one {live_bytes} B")
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        # the plain steps from the same seed and batches
        before = torch.cuda.memory_allocated()
        model = Model(cfg, device=dev, seed=0)
        state = init_train_state(model, opt)
        step = make_train_step(model, opt_cfg=opt, remat=True,
                               microbatches=micro)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p_losses, p_secs = [], []
        for b_ in batches:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m_ = step(state, b_)
            p_losses.append(m_["loss"].item())
            p_secs.append(time.perf_counter() - t1)
        rise = torch.cuda.max_memory_allocated() - before
        plain = {k: v.detach() for k, v in state["params"].items()}
        p_busy, p_wall = profiled_step(torch,
                                       lambda: step(state, batches[-1]))
        plain_live = sum(t.nbytes for t in (
            *plain.values(), *state["opt"]["m"].values(),
            *state["opt"]["v"].values(), state["opt"]["step"]))
        check(plain_live == live_bytes,
              f"pod: the sharded state holds {live_bytes} B, the plain one "
              f"{plain_live} B")
        print(f"pod (a): {arch} at its published width, batch {B} x {T}, "
              f"remat, microbatches {micro}, over a (1, 1) mesh on NCCL, "
              f"{len(plain)} parameters equal bit for bit after "
              f"{POD_STEPS} + 1 steps: "
              f"sharded losses {s_losses}, plain {p_losses}; seconds a step "
              f"sharded {[round(s, 4) for s in s_secs]}, plain "
              f"{[round(s, 4) for s in p_secs]}; busy (torch.profiler, one "
              f"step after the timed ones) sharded {s_busy:.1f} ms of device "
              f"time, plain {p_busy:.1f} ms; peak memory rise over the "
              f"plain steps {rise / 2**30:.2f} GiB")
        print(f"pod (a): the profiled step: sharded {s_wall:.4f} s "
              f"({100 * s_busy / 1e3 / s_wall:.1f}% busy), plain "
              f"{p_wall:.4f} s ({100 * p_busy / 1e3 / p_wall:.1f}% busy)")
        check(s_losses == p_losses,
              f"pod: sharded losses {s_losses} != plain {p_losses}")
        differ = [k for k in plain if not torch.equal(sharded[k], plain[k])]
        check(not differ, f"pod: {len(differ)} parameters differ, e.g. "
              f"{differ[:3]}")
        differ3 = [k for k in plain if not torch.equal(pod3[k], plain[k])]
        print(f"pod (a): the same over a (1, 1, 1) (pod, data, model) mesh "
              f"(laid out (pod+data, model)): losses {p3_losses}, seconds "
              f"a step {[round(s, 4) for s in p3_secs]}, {len(plain)} "
              f"parameters equal to the plain ones bit for bit: "
              f"{not differ3} ({p3_run:.1f} s with the state's layout)")
        check(p3_losses == p_losses,
              f"pod: (1, 1, 1) losses {p3_losses} != plain {p_losses}")
        check(not differ3, f"pod: {len(differ3)} parameters of the (1, 1, 1) "
              f"run differ, e.g. {differ3[:3]}")
        del state, step, model, plain, sharded, pod3
        torch.cuda.empty_cache()

        # (b) the dry run's reckoning of the same cell
        out, err = reckon.communicate(timeout=POD_SUBPROCESS_S)
        check(reckon.returncode == 0,
              f"pod (b): the reckoning failed: {err[-3000:]}")
        rec = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("RECKONED ")][-1][9:])
        mem = rec["memory"]
        args = live_bytes + batch_bytes
        check(mem["argument_size_in_bytes"] == args,
              f"pod (b): reckoned argument bytes "
              f"{mem['argument_size_in_bytes']} != live {args}")
        ratio = mem["peak_memory_in_bytes"] / rise
        print(f"pod (b): reckoned on a fake (1, 1) world: argument bytes "
              f"{mem['argument_size_in_bytes']} == the live state's and "
              f"batch's; peak {mem['peak_memory_in_bytes'] / 2**30:.2f} GiB "
              f"vs the measured rise {rise / 2**30:.2f} GiB (ratio "
              f"{ratio:.3f}); traced FLOPs {rec['cost']['flops']:.4e} vs "
              f"step_flops {FL.step_flops(cfg, B, T, 'train', remat=True):.4e}"
              f"; collectives {rec['collectives']['by_op_count']}; trace "
              f"{rec['timings']['trace_s']:.1f} s")
        check(abs(ratio - 1) <= POD_PEAK_TOL,
              f"pod (b): reckoned peak off the measured rise by "
              f"{100 * (ratio - 1):.1f}%")

        # (c) one production cell at full width
        out, err = cell.communicate(timeout=POD_SUBPROCESS_S)
        check(cell.returncode == 0,
              f"pod (c): the production cell failed: {err[-3000:]}")
        for ln in out.splitlines():
            if ln.startswith("[") or ln.startswith("  memory"):
                print(f"pod (c): {ln[:400]}")
    finally:
        for p in (reckon, cell):
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    print(f"pod phase: {time.perf_counter() - t0:.1f} s")


def pool_merge_cases(torch, np, ops, ref, errs: dict, *, part, q, md,
                     raw_leaf, first: int, seed, final, live, live_t) -> dict:
    """Phase 9's records of ``pool_merge`` at the exact loop's first group
    (leaf ``first`` of the tree behind ``part``, its bound ``md``): the
    pools as the seed (``seed``: its distances and rows) leaves them, and
    as the batch ends (``final``: its answers), where nothing enters.
    Checks each against the twin bit for bit, and its live pairs against
    scan_verify's (``live``, ``live_t``: pairs and rows), recording the
    error in ``errs``.  A launch changes its pools, so each gets a fresh
    copy made before the timing; marks and counts only accumulate and are
    shared."""
    tree, leaf = part.source, part.leaf_size
    nq, nl = md.shape
    dev = q.device
    dd_leaf = ops.batch_euclid_multi(q, raw_leaf)
    leaf_ix = torch.tensor([first], dtype=torch.int64, device=dev)
    tree_ids = part.device_report_ids()
    seed_d, seed_idx = seed
    sd, si = torch.sort(seed_d, dim=1, stable=True)
    pools = {
        "pool_merge": (sd[:, :K].contiguous(),
                       tree_ids[seed_idx.gather(1, si[:, :K])].contiguous()),
        "pool_merge_tight": (
            torch.from_numpy(np.ascontiguousarray(final[0], np.float32)
                             ).to(dev),
            torch.from_numpy(np.ascontiguousarray(final[1], np.int64)
                             ).to(dev))}
    shared = dict(
        ext=torch.full((nq,), float("inf"), device=dev),
        counts=torch.zeros(nq, dtype=torch.int64, device=dev),
        row_mark=torch.zeros(tree.n_leaves * leaf, dtype=torch.uint8,
                             device=dev),
        leaf_mark=torch.zeros((nq, tree.n_leaves), dtype=torch.uint8,
                              device=dev))

    def states(name, n):
        d_, o_ = pools[name]
        return iter([dict(shared, best_d=d_.clone(), best_off=o_.clone())
                     for _ in range(n)])

    def run(fn, it):
        return lambda: fn(md, dd_leaf, leaf_ix, leaf, None, tree_ids,
                          **next(it))

    for name, (pairs, _) in (("pool_merge", live),
                             ("pool_merge_tight", live_t)):
        got, want = ({n_: t.clone() for n_, t in next(states(
            name, 1)).items()} for _ in range(2))
        ops.pool_merge(md, dd_leaf, leaf_ix, leaf, None, tree_ids, **got)
        ref.pool_merge_ref(md, dd_leaf, leaf_ix, leaf, None, tree_ids, **want)
        for n_, t in got.items():
            w_ = want[n_]
            if t.dtype == torch.float32:
                t, w_ = t.view(torch.int32), w_.view(torch.int32)
            check(torch.equal(t, w_),
                  f"{name} differs at main-path shape ({n_})")
            errs[name] = max(errs.get(name, 0.0), max_abs_err(torch, t, w_))
        check(int(got["counts"].sum()) == pairs,
              f"{name} counted {int(got['counts'].sum())} live pairs, "
              f"scan_verify {pairs} under the same bound")
    n_states = TIMED + PLAIN_TIMED + 8      # more than the timer calls

    def bound(pairs, live_rows):
        """The least work: the bound md read once; per live pair its
        distance, per live row its id and mark; the pools and the external
        bound read, the counts read and written, the pools written back, a
        leaf mark a query.  Operations: a compare a pair, no arithmetic."""
        return bound_ms(nq * nl * 4 + pairs * 4 + live_rows * 9
                        + nq * K * 12 * 2 + nq * (4 + 8 * 2 + 1), nq * nl)

    out = {}
    for name, (pairs, rows), when in (
            ("pool_merge", live, "the seed's pools"),
            ("pool_merge_tight", live_t, "the batch's final pools")):
        out[name] = dict(
            source="src/repro_torch/kernels/csrc/pool_merge.cu",
            replaces="none (the reference merges on the host: "
                     "src/repro/query/merger.py:116 merge_topk)",
            shape=f"Q={nq} x B={nl} rows (one leaf), k={K}, {when}: "
                  f"{pairs} live pairs, {rows} live rows",
            fn=run(ops.pool_merge, states(name, n_states)),
            plain=run(ref.pool_merge_ref, states(name, n_states)),
            library=None,
            bound=bound(pairs, rows))
    out["pool_merge_tight"]["launches_of"] = "pool_merge"
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
    # executor verifies every row of one leaf group per launch, then folds
    # the group into the pools on the card with one pool_merge launch)
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
    for name in ("mindist_batch", "batch_euclid", "batch_euclid_gather",
                 "pool_merge"):
        check(eager_launches.get(name, 0) > 0,
              f"eager search launched no {name}: {eager_launches}")
    # one cross-form launch and one fold a group issued, and at Q = 64 a
    # group is one leaf: every surviving leaf's group went through the fold
    check(eager_launches["pool_merge"] == len(cross_rows)
          == e_stats.leaves_scanned,
          f"eager search: {eager_launches['pool_merge']} pool_merge "
          f"launches, {len(cross_rows)} cross-form launches, "
          f"{e_stats.leaves_scanned} leaves scanned")
    check(e_stats.host_syncs == 3,
          f"eager search waited {e_stats.host_syncs} times, not 3 (2 for "
          f"the seed, 1 for the pools' copy back)")
    t0 = time.perf_counter()
    e_d2, e_o2, e_stats2 = T.exact_search_batch(tree, queries, k=K)
    eager_s = time.perf_counter() - t0
    check(np.array_equal(e_o, e_o2) and np.array_equal(e_d, e_d2),
          "two eager runs disagree")
    tm = e_stats2.timings
    staged = sum(tm.get(s, 0.0)
                 for s in ("seed", "bound", "verify", "merge", "sync"))
    host = tm["scan"] - staged
    print(f"eager: Q={N_QUERIES} k={K}: {eager_cold_s:.3f} s first batch, "
          f"{eager_s:.3f} s per batch warm; launches {eager_launches}")
    print("eager split (s): " + ", ".join(
        f"{s}={tm.get(s, 0.0) / 1e3:.3f}"
        for s in ("plan", "seed", "bound", "verify", "merge", "sync"))
        + f", host-other={host / 1e3:.3f}, scan={tm['scan'] / 1e3:.3f}")
    issue_us = (tm["bound"] + tm["verify"] + tm["merge"]) * 1e3
    print(f"eager issue: {issue_us / len(cross_rows):.1f} us of host time a "
          f"group (the bound, verify and merge stages over "
          f"{len(cross_rows)} groups; the seed's merge included)")
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
    kernel_total(e_prof, "pool_merge", "eager pool_merge kernels")

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

    # -- 8: the storage path (and phase 12's budgets off the file) -------------
    t0 = time.perf_counter()
    seg_out = segment_phase(torch, np, x, tree, queries, (e_d, e_o))
    torch.cuda.empty_cache()
    print(f"segment phase: {time.perf_counter() - t0:.1f} s")

    # -- 10: streaming ingest at full width (btp) --------------------------------
    t0 = time.perf_counter()
    stream_l, stream_out = streaming_phase(torch, np, x, queries)
    torch.cuda.empty_cache()
    print(f"streaming phase: {time.perf_counter() - t0:.1f} s")

    # -- 11: the three modes and the concurrent engine at 1/8 depth --------------
    t0 = time.perf_counter()
    modes_l, modes_answer = modes_phase(torch, np, x, queries)
    torch.cuda.empty_cache()
    print(f"modes phase: {time.perf_counter() - t0:.1f} s")

    # -- 13: the durable engine (run while phase 3's walks are on the card) ---
    t0 = time.perf_counter()
    durable_l = durable_phase(torch, np, x, queries, stream_out, modes_answer)
    torch.cuda.empty_cache()
    print(f"durable phase: {time.perf_counter() - t0:.1f} s")

    # -- 15: the sharded engine, threaded and mesh, and a rebalance -------------
    t0 = time.perf_counter()
    sharded_l, mesh_sub = sharded_phase(torch, np, x, queries, stream_out)
    torch.cuda.empty_cache()
    print(f"sharded phase: {time.perf_counter() - t0:.1f} s")

    # -- 16: the sharded store: reopen, tiers, a concurrent engine --------------
    t0 = time.perf_counter()
    store_l = sharded_store_phase(torch, np, x, queries, modes_answer)
    torch.cuda.empty_cache()
    print(f"sharded store phase: {time.perf_counter() - t0:.1f} s")

    # -- 17: the static sharded tree over phase 3's walks -----------------------
    t0 = time.perf_counter()
    static_l = static_sharded_phase(torch, np, x, queries, (e_d, e_o))
    print(f"static sharded phase: {time.perf_counter() - t0:.1f} s")

    # -- 18: obs on the card ------------------------------------------------------
    t0 = time.perf_counter()
    obs_l = obs_phase(torch, np, x, tree, queries, (e_d, e_o), eager_s)
    del x
    torch.cuda.empty_cache()
    print(f"obs phase: {time.perf_counter() - t0:.1f} s")

    # -- 12: budgeted search on the tree -----------------------------------------
    t0 = time.perf_counter()
    budget_l = budget_phase(torch, np, tree, queries, (e_d, e_o), (b_d, b_o))
    print(f"budget phase: {time.perf_counter() - t0:.1f} s")

    # -- 14: the Coconut-Trie and the iSAX top-down baseline ------------------------
    t0 = time.perf_counter()
    trie_l = trie_phase(torch, np, tree)
    print(f"trie phase: {time.perf_counter() - t0:.1f} s")

    # -- 19: serving: decode at llama3.2-1b's width feeding the index -------------
    t0 = time.perf_counter()
    serve_l = serving_phase(torch, np)
    print(f"serving phase: {time.perf_counter() - t0:.1f} s")

    # -- 20: training at llama3.2-1b's width, and the trainer's parts ------------
    t0 = time.perf_counter()
    train_l = training_phase(torch, np)
    print(f"training phase: {time.perf_counter() - t0:.1f} s")

    # -- 21: the pod tooling: a sharded step on NCCL, the dry run vs the card --
    pod_phase(torch, np)

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
    # one sub-shard of the mesh launch: after the flush no buffer bounds
    # the launch, so every row that is not padding is live for every query
    mc, mr, mdead = mesh_sub["codes"], mesh_sub["raw"], mesh_sub["dead"]
    mdead_i32 = mdead.to(torch.int32)
    mcap, mrows = mesh_sub["cap"], mesh_sub["rows"]
    unbounded = torch.full((N_QUERIES,), float("inf"), device=dev)
    sv_mesh = ops.scan_verify(q, q_paas, mc, mr, unbounded, cfg, k=K,
                              dead=mdead)
    check(int(sv_mesh[3]) == mrows, f"scan_verify mesh shape: "
          f"{int(sv_mesh[3])} live rows of {mrows}")
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
            ("mindist", ops.mindist(q_paas[0], tree.codes, cfg),
             ref.mindist_batch_ref(q_paas[:1], tree.codes, lower, upper,
                                   scale)[0]),
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
            *(("scan_verify_mesh", g, w_) for g, w_ in zip(
                sv_mesh, ref.scan_verify_ref(
                    q, q_paas, mc, mr, lower, upper, unbounded, mdead_i32,
                    scale=scale, k=K))),
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
    pm_cases = pool_merge_cases(
        torch, np, ops, ref, errs, part=part, q=q, md=md, raw_leaf=raw_leaf,
        first=first, seed=(seed_d, seed_idx), final=(e_d, e_o),
        live=(live_pairs, union), live_t=(live_pairs_t, union_t))
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
        "mindist": dict(
            source="src/repro_torch/kernels/csrc/mindist_batch.cu",
            replaces="src/repro/kernels/mindist_scan.py:65",
            shape=f"Q=1 x N={tree.n} rows (ops.mindist: "
                  f"exact_search_budgeted's whole-tree bound), w={w}",
            fn=lambda: ops.mindist(q_paas[0], tree.codes, cfg),
            plain=lambda: ref.mindist_batch_ref(q_paas[:1], tree.codes,
                                                lower, upper, scale)[0],
            library=None,
            bound=md_bound(1, tree.n, w)),
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
        "scan_verify_mesh": dict(
            source="src/repro_torch/kernels/csrc/scan_verify.cu",
            replaces="src/repro/kernels/scan_verify.py:130",
            shape=f"Q={nq} x N={mcap} rows (one sub-shard of phase 15's "
                  f"mesh launch: {mrows} rows and {mcap - mrows} padding), "
                  f"k={K}, no bound (no buffer after the flush): every "
                  f"(query, row) pair verified",
            launches_of="scan_verify",
            fn=lambda: ops.scan_verify(q, q_paas, mc, mr, unbounded, cfg,
                                       k=K, dead=mdead),
            plain=lambda: ref.scan_verify_ref(
                q, q_paas, mc, mr, lower, upper, unbounded, mdead_i32,
                scale=scale, k=K),
            library=None,
            # the codes and dead flags of the sub-shard, its live rows and
            # the queries once each, the outputs; per live pair the bound
            # (7w) and the ED (3L - 1)
            bound=bound_ms(mcap * (w + 1) + mrows * L * 4
                           + nq * (L + w + 2) * 4 + 2 * card * 4
                           + nq * K * 8 + 4,
                           nq * mrows * (7 * w + 3 * L - 1))),
        **pm_cases,
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
                  *seg_out["launches"].values(), *stream_l.values(),
                  *modes_l.values(), *durable_l.values(),
                  *budget_l.values(), *trie_l.values(),
                  *sharded_l.values(), *store_l.values(),
                  *static_l.values(), *obs_l.values(),
                  *serve_l.values(), *train_l.values()):
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

    # the launch floor under the same events: a one-element fill
    one = torch.zeros(1, device=dev)
    floor_ms = timer.ms(lambda: one.fill_(1.0))
    print(f"launch floor [a one-element fill, L2 cold]: {floor_ms:.4f} ms")

    # ops.mindist over one leaf, the single-query kernel's earlier row
    ms1 = timer.ms(lambda: ops.mindist(q_paas[0], codes_leaf, cfg))
    plain1 = timer.ms(lambda: ref.mindist_batch_ref(
        q_paas[:1], codes_leaf, lower, upper, scale), reps=PLAIN_TIMED)
    b1, by1 = md_bound(1, nl, w)
    print(f"kernel mindist at Q=1 (ops.mindist) [N={nl} rows, L2 "
          f"cold]: {ms1:.4f} ms (plain {plain1:.4f} ms, bound {b1:.4f} ms "
          f"by {by1})")

    # -- the record and the result -----------------------------------------------
    print(json.dumps({"kernels": record}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == DURABLE_CHILD:
        sys.exit(durable_child(sys.argv[2]))
    sys.exit(main())
