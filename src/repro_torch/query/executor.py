"""Plan execution: seed -> leaf-masked lower-bound scan -> verify.

Sorted partitions are scanned leaf-granularly (surviving leaves only,
cheapest fence bound first — skip-sequential SIMS); unsorted frozen
buffers are copied to the partition's device and brute-force verified
with the same Euclidean kernel (:func:`buffer_topk`), so answer
*distances* are bit-identical however the rows are partitioned — the
invariant the streaming engine is built on.

A device-backed partition (a tree, on the card or the CPU) keeps its
k-NN pools on its device through the leaf-group loop
(:class:`~repro_torch.query.merger.DeviceKnnPool`): per group the bound,
the cross ED over the group's rows and the ``pool_merge`` fold are issued
without waiting, and the pools come back to the host once, at the
partition's end.  The groups, their order and so each group's bound are
the host loop's, and the fold keeps ``merge_topk``'s contract, so
answers and counters do not depend on which loop ran.  A segment
partition, the fused path and a k above the kernel's keep the host loop,
the reference's structure: per leaf group one device-to-host copy of the
bound, a host-side live mask, one verification launch over the rows any
query kept, and per-query :class:`KnnPool` updates.  A segment partition
reads each group's rows off its mmap (or its tier cache) and copies them
to its device first; a format-v3 segment's code rows go to the
``unpack_mindist`` kernel in their packed form when the bound is the
default one.

The default chain runs on the partition's device through
:mod:`repro_torch.kernels.ops`: ``mindist_batch`` lower bounds (marked as
the default bound, ``_coconut_default_mindist``) and ``batch_euclid_multi``
verification; seed distances use the gathered form of the same ED routine,
so answer *distances* are bit-identical whichever path computed them.
``scan_mode="kernel"`` opts into the fused ``scan_verify`` kernel (one
pass: bound + masked verify + top-k on the device) on device-backed
partitions; on a segment the fusion would stream every pruned row's raw
bytes off disk, so segments keep the eager chain, as in the reference.

Stage timings (``SearchStats.timings``, milliseconds), each also a span
of the same name while tracing is on (:func:`repro_torch.obs.stage`: one
pair of clock readings gives both): ``plan`` (the queries' PAA and the
planner), ``seed`` (one sorted partition's probe: ``seed.window``, the
query summaries, z-order keys, key search and copy back;
``seed.distances``, the gathered ED, copy back and ``alive`` mask; and
its ``merge``), ``bound`` (row indices, code gather, bound launch, and
in the host loop the copy back and live mask), ``verify`` (row gather, ED
or fused launch, and in the host loop the copy back), ``merge`` (host
pool updates after the seeds, each host-loop group and the buffer; the
``pool_merge`` launch of a device-loop group), ``sync`` (a device loop's
one wait: the pools and counters copied back), ``buffer`` (the
brute-force scan of an unsorted buffer: copy to the device, ED, sort,
copy back and its ``merge``) and ``scan`` (everything after planning,
timed apart from the per-partition ``scan`` spans, which carry
``device_pool`` and ``groups``).  On a device loop ``bound``, ``verify``
and ``merge`` time the host's issue of the launches, not the card's work.
``SearchStats.host_syncs`` counts the round trips: two per seed probe,
one per device loop, one per bound and per verification of a host-loop
group (four on the fused path), and two per buffer scan.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import summarization as S
from ..kernels import ops
from ..obs import record_search, span as _span, stage
from .merger import DeviceKnnPool, KnnPool, SearchStats
from .partition import Partition
from .planner import ScanEntry, ScanPlan, build_plan

__all__ = ["execute", "exact_knn", "buffer_topk", "SCAN_MODES"]

SCAN_MODES = (None, "kernel")


def _host(x, stats: Optional[SearchStats] = None) -> np.ndarray:
    """A (device) result as a host array.  A tensor is a round trip the
    search waits for: it counts one ``stats.host_syncs``, on the CPU as
    on the card."""
    if isinstance(x, torch.Tensor):
        if stats is not None:
            stats.host_syncs += 1
        return x.cpu().numpy()
    return np.asarray(x)


def _queries_np(queries) -> np.ndarray:
    if isinstance(queries, torch.Tensor):
        queries = queries.detach().cpu().numpy()
    return np.atleast_2d(np.asarray(queries, np.float32))


def _ms_since(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def buffer_topk(queries_t: torch.Tensor, rows: np.ndarray, offs: np.ndarray,
                k: int, io=None, stats: Optional[SearchStats] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force per-query ``[Q, k]`` pools over unsorted host rows —
    THE buffer-scan contract (stable sort, (inf, -1) padding) shared by
    the exact executor and the budgeted drain.  The rows are copied to
    the queries' device and go through the cross form of the verification
    kernel, whose lane order gives a (query, row) pair the same bits on
    every path, so the distances always equal a post-flush search of the
    same rows.  Ties keep the lower buffer position (a stable sort on the
    device)."""
    nq = queries_t.shape[0]
    best_d = np.full((nq, k), np.inf, np.float32)
    best_off = np.full((nq, k), -1, np.int64)
    if len(rows) == 0:
        return best_d, best_off
    if io is not None:
        io.seq_read(len(rows))
    rows_t = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(
        queries_t.device)
    d = ops.batch_euclid_multi(queries_t, rows_t)                # [Q, M]
    take = min(k, d.shape[1])
    vals, sel = torch.sort(d, dim=1, stable=True)
    best_d[:, :take] = _host(vals[:, :take], stats)
    best_off[:, :take] = np.asarray(offs, np.int64)[
        _host(sel[:, :take], stats)]
    return best_d, best_off


def _scan_buffer(entry: ScanEntry, queries_t: torch.Tensor, k: int,
                 pool: KnnPool, stats: SearchStats, io) -> None:
    part = entry.partition
    with stage(stats, "buffer") as sp:
        rows = part.buffer_raw()
        offs = part.report_ids()
        if entry.ts_min is not None:
            keep = np.nonzero(part.timestamps() >= entry.ts_min)[0]
            rows, offs = rows[keep], offs[keep]
        sp.set(rows=len(rows))
        if len(rows):
            new_d, new_off = buffer_topk(queries_t, rows, offs, k, io=io,
                                         stats=stats)
            with stage(stats, "merge"):
                pool.update_batch(new_d, new_off)
            stats.buffer_rows += len(rows)
            stats.candidates_per_query += len(rows)


def _seed_sorted(entry: ScanEntry, queries_t: torch.Tensor, pool: KnnPool,
                 stats: SearchStats, *, radius_leaves: int, io
                 ) -> Tuple[Optional[np.ndarray], np.ndarray, np.ndarray]:
    """Seed the pool from the leaves around each query's z-order slot
    (the Algorithm-4 probe).  Returns ``(alive, offs_all, idx0)`` for the
    scan that follows (``idx0``: the probed rows ``[Q, span]``, host).
    Shared by the exact path and the budgeted drain, so seed distance
    bits are identical by construction.  Runs inside the caller's
    ``seed`` stage, with its own stages as children."""
    part = entry.partition
    nq = queries_t.shape[0]
    alive = None
    if entry.ts_min is not None:
        ts = part.timestamps()
        if ts is not None:
            alive = ts >= entry.ts_min
    offs_all = part.report_ids()
    with stage(stats, "seed.window"):
        idx0_t = part.seed_window(queries_t, radius_leaves=radius_leaves,
                                  io=io, stats=stats)
        idx0 = _host(idx0_t, stats)
    with stage(stats, "seed.distances", rows=idx0.size):
        d0 = _host(part.seed_distances(queries_t, idx0_t, io=io), stats)
        if alive is not None:
            d0 = np.where(alive[idx0], d0, np.inf).astype(np.float32)
            offs0 = np.where(alive[idx0], offs_all[idx0], -1)
        else:
            offs0 = offs_all[idx0]
    with stage(stats, "merge"):
        for qi in range(nq):
            pool.update(qi, d0[qi], offs0[qi])
    return alive, offs_all, idx0


def _leaves_per_group(chunk: int, nq: int, leaf: int) -> int:
    """Leaves per verification group: bound the [Q, B, L] intermediate
    (rows-per-chunk scales down with batch size)."""
    eff_chunk = min(chunk, max(64, 32768 // nq))
    return max(1, eff_chunk // leaf)


def _scan_leaf_group(entry: ScanEntry, queries_t, q_paas_t,
                     grp: np.ndarray, k: int, pool: KnnPool,
                     stats: SearchStats, alive, offs_all,
                     leaf_mark, union_mark, io, mindist_fn,
                     fused: bool) -> Tuple[int, int]:
    """Bound + verify one sorted group of leaf indices against the pool.

    Returns ``(live_pairs, nbytes)`` where ``nbytes`` counts the code
    rows streamed plus the raw rows fetched for verification — computed
    from shapes so the charge is identical across backends."""
    part = entry.partition
    nq = queries_t.shape[0]
    leaf = part.leaf_size
    raw_bytes = part.cfg.series_len * 4
    with stage(stats, "bound") as bsp:
        row_idx = (grp[:, None] * leaf
                   + np.arange(leaf)[None, :]).reshape(-1)
        row_idx = row_idx[row_idx < part.n]
        nbytes = len(row_idx) * part.cfg.segments
        bsp.set(rows=len(row_idx))
        if fused:
            codes_blk = part.codes_rows(row_idx, io=io)
        else:
            # packed fast path: a v3 segment's stored-form rows go straight
            # to the unpack_mindist kernel when the bound is the default
            # one (no host decode; hot tier blocks are already on the
            # device).  Both bounds give the same bits, so answers never
            # depend on which one ran.
            if part.is_packed and getattr(
                    mindist_fn, "_coconut_default_mindist", False):
                md = _host(ops.mindist_batch_packed(
                    q_paas_t, part.codes_rows_packed(row_idx, io=io),
                    part.cfg), stats)
            else:
                md = _host(mindist_fn(q_paas_t,
                                      part.codes_rows(row_idx, io=io)),
                           stats)
            live = md < pool.bound()[:, None]
            if alive is not None:
                live &= alive[row_idx][None, :]
            live_pairs = int(live.sum())
            keep = live.any(axis=0)
            block = row_idx[keep]
            mask = live[:, keep]
    if fused:
        live_pairs = _verify_fused(
            entry, queries_t, q_paas_t, codes_blk, row_idx, k, pool,
            stats, alive, offs_all, leaf_mark, union_mark, io)
        # the fused kernel takes the whole group's raw rows (that IS the
        # fusion), so the group charges every row's raw bytes
        return live_pairs, nbytes + len(row_idx) * raw_bytes
    if not len(block):
        return live_pairs, nbytes
    with stage(stats, "verify", rows=len(block), candidates=len(block),
               raw_bytes=len(block) * raw_bytes):
        rows = part.series_rows(block, io=io)
        if part.backend == "device" and io is not None:
            io.seq_read(len(block))
        dd = _host(ops.batch_euclid_multi(queries_t, rows), stats)  # [Q, B]
    with stage(stats, "merge"):
        nbytes += len(block) * raw_bytes
        stats.candidates += len(block)
        union_mark[block // leaf] = True
        for qi in range(nq):
            m = mask[qi]
            if not m.any():
                continue
            stats.candidates_per_query[qi] += int(m.sum())
            leaf_mark[qi, block[m] // leaf] = True
            pool.update(qi, dd[qi][m], offs_all[block[m]])
    return live_pairs, nbytes


def _scan_sorted(entry: ScanEntry, queries_t, q_paas_t, k: int,
                 pool: KnnPool, stats: SearchStats, *,
                 radius_leaves: int, chunk: int, io, mindist_fn,
                 fused: bool, label: str = "") -> Tuple[int, int, bool]:
    """Seed + leaf-skip scan + verify one sorted partition.  Returns the
    number of live (query, row) pairs the lower bound could not prune,
    the leaf groups issued, and whether the pools stayed on the device."""
    part = entry.partition
    nq = queries_t.shape[0]
    leaf = part.leaf_size

    with stage(stats, "seed", radius_leaves=radius_leaves):
        alive, offs_all, _ = _seed_sorted(entry, queries_t, pool, stats,
                                          radius_leaves=radius_leaves, io=io)

    # -- leaf-granular pruning against the fence bounds --------------------
    # (the seed probe above always runs — the external bsf and the fence
    # bounds prune the SCAN, never the seeds)
    with _span("prune", leaves=part.n_leaves) as psp:
        bound = pool.bound()
        if np.all(entry.part_bound >= bound):  # whole-partition fast path
            stats.partitions_pruned += 1
            stats.leaves_pruned += part.n_leaves
            psp.set(leaves_pruned=part.n_leaves, whole_partition=True)
            return 0, 0, False
        lb = entry.leaf_bounds                                # [Q, n_leaves]
        surv = np.nonzero((lb < bound[:, None]).any(axis=0))[0]
        stats.leaves_pruned += lb.shape[1] - len(surv)
        stats.leaves_scanned += len(surv)
        psp.set(leaves_pruned=lb.shape[1] - len(surv),
                leaves_surviving=len(surv))
        if len(surv) == 0:
            stats.partitions_pruned += 1
            psp.set(whole_partition=True)
            return 0, 0, False
        # cheapest leaves first: the bound tightens fastest, pruning the rest
        surv = surv[np.argsort(lb[:, surv].min(axis=0), kind="stable")]

    leaves_per_grp = _leaves_per_group(chunk, nq, leaf)
    groups = [np.sort(surv[g:g + leaves_per_grp])   # sequential within grp
              for g in range(0, len(surv), leaves_per_grp)]
    if part.backend == "device" and not fused and k <= ops.POOL_MAX_K:
        return _scan_device(entry, queries_t, q_paas_t, groups, pool, stats,
                            io=io, mindist_fn=mindist_fn, label=label)
    leaf_mark = np.zeros((nq, lb.shape[1]), bool)
    union_mark = np.zeros(lb.shape[1], bool)
    live_pairs = 0
    for grp in groups:
        live, nbytes = _scan_leaf_group(
            entry, queries_t, q_paas_t, grp, k, pool, stats, alive,
            offs_all, leaf_mark, union_mark, io, mindist_fn, fused)
        live_pairs += live
        stats.scan_bytes += nbytes
    stats.leaves_touched += int(union_mark.sum())
    stats.leaves_per_query += leaf_mark.sum(axis=1)
    if label:
        stats.touch_leaves(label, np.nonzero(union_mark)[0])
    return live_pairs, len(groups), False


def _scan_device(entry: ScanEntry, queries_t, q_paas_t,
                 groups: Sequence[np.ndarray], pool: KnnPool,
                 stats: SearchStats, *, io, mindist_fn, label: str
                 ) -> Tuple[int, int, bool]:
    """The leaf-group loop of a device-backed partition, with the pools on
    the card (:class:`DeviceKnnPool`): per group the bound, the cross ED
    over the group's rows and the ``pool_merge`` fold are issued without
    waiting, and the partition's one wait is the ``sync`` stage's copy
    back.  Same groups in the same order, so each group sees the bound the
    host loop gives it, and the same answers and counters."""
    part = entry.partition
    leaf, n = part.leaf_size, part.n
    dev = queries_t.device
    dpool = DeviceKnnPool(pool, dev, n_leaves=part.n_leaves, leaf_size=leaf)
    order = torch.from_numpy(np.concatenate(groups)).to(dev)
    ids = part.device_report_ids()
    dead = part.device_dead(entry.ts_min)
    # a group's rows: whole leaves, but the partition's last may be short
    # (it sorts last in its group)
    sizes = [(len(grp) - 1) * leaf + min(leaf, n - int(grp[-1]) * leaf)
             for grp in groups]
    _issue_groups(part, queries_t, q_paas_t, groups, sizes, order, dpool,
                  dead, ids, stats, mindist_fn)
    with stage(stats, "sync"):
        live, leaves, verified = dpool.store(pool)
        stats.host_syncs += 1
    if io is not None:
        for grp in groups:
            if verified[grp].any():
                io.seq_read(int(verified[grp].sum()))
    touched = verified > 0
    stats.candidates += int(verified.sum())
    stats.candidates_per_query += live
    stats.leaves_per_query += leaves
    stats.leaves_touched += int(touched.sum())
    stats.scan_bytes += (sum(sizes) * part.cfg.segments
                         + int(verified.sum()) * part.cfg.series_len * 4)
    if label:
        stats.touch_leaves(label, np.nonzero(touched)[0])
    return int(live.sum()), len(groups), True


def _issue_groups(part: Partition, queries_t, q_paas_t,
                  groups: Sequence[np.ndarray], sizes: Sequence[int],
                  order: torch.Tensor, dpool: DeviceKnnPool, dead, ids,
                  stats: SearchStats, mindist_fn) -> None:
    """Issue every group's launches, cheapest group first, waiting for
    nothing: a one-leaf group reads its rows as slices of the tree's
    columns, a larger one gathers them through row numbers made on the
    device from ``order`` (the groups' leaves, uploaded once)."""
    leaf, src = part.leaf_size, part.source
    lanes = torch.arange(leaf, device=order.device)
    at = 0
    for grp, b in zip(groups, sizes):
        leaves = order[at:at + len(grp)]
        at += len(grp)
        with stage(stats, "bound", rows=b):
            if len(grp) == 1:
                s = int(grp[0]) * leaf
                sel = slice(s, s + b)
            else:
                sel = (leaves[:, None] * leaf + lanes).reshape(-1)[:b]
            md = mindist_fn(q_paas_t, src.codes[sel])
        with stage(stats, "verify", rows=b,
                   raw_bytes=b * part.cfg.series_len * 4):
            dd = ops.batch_euclid_multi(queries_t, src.series(sel))
        with stage(stats, "merge"):
            dpool.fold(md, dd, leaves, dead, ids)


def _verify_fused(entry: ScanEntry, queries_t, q_paas_t, codes_blk,
                  row_idx: np.ndarray, k: int, pool: KnnPool,
                  stats: SearchStats, alive, offs_all,
                  leaf_mark, union_mark, io) -> int:
    """Fused-kernel verification of one leaf group: bound + masked
    Euclidean + on-device top-k in a single pass.

    ``candidates``/``candidates_per_query`` match the eager chain (the
    kernel reports per-query and union live counts); leaf attribution is
    top-k-grained — only the rows that survive into the pool mark their
    leaves, since the full live mask never leaves the device."""
    part = entry.partition
    nq = queries_t.shape[0]
    dev = queries_t.device
    with stage(stats, "verify", rows=len(row_idx), fused=True,
               raw_bytes=len(row_idx) * part.cfg.series_len * 4) as vsp:
        rows = part.series_rows(row_idx, io=io)
        bound = torch.as_tensor(pool.bound(), device=dev)
        dead = None
        if alive is not None:
            dead = torch.as_tensor(~alive[row_idx], device=dev)
        d, li, counts, union = ops.scan_verify(
            queries_t, q_paas_t, codes_blk, rows, bound, part.cfg,
            k=min(k, len(row_idx)), dead=dead)
        d = _host(d, stats)
        li = _host(li, stats)
        counts = _host(counts, stats)
        union = int(_host(union, stats))
        stats.candidates += union
        vsp.set(candidates=union)
    with stage(stats, "merge"):
        live = 0
        for qi in range(nq):
            stats.candidates_per_query[qi] += int(counts[qi])
            live += int(counts[qi])
            fin = np.isfinite(d[qi])
            if not fin.any():
                continue
            rows_qi = row_idx[li[qi][fin]]
            leaf_mark[qi, rows_qi // part.leaf_size] = True
            union_mark[rows_qi // part.leaf_size] = True
            pool.update(qi, d[qi][fin], offs_all[rows_qi])
        if io is not None:
            io.seq_read(len(row_idx))
    return live


def _default_mindist(cfg: S.SummaryConfig):
    fn = lambda qp, c: ops.mindist_batch(qp, c, cfg)  # noqa: E731
    # marks the bound as the default kernel: the packed-code scan is
    # bit-equal to it, injected bounds opt out
    fn._coconut_default_mindist = True
    return fn


def execute(plan: ScanPlan, queries, *, k: int = 1,
            bsf: Optional[np.ndarray] = None,
            radius_leaves: int = 1, chunk: int = 4096,
            io=None, mindist_fn=None,
            scan_mode: Optional[str] = None
            ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Run a :class:`ScanPlan` and return (dists ``[Q, k]``, ids
    ``[Q, k]``, :class:`SearchStats`).

    ``bsf``: optional ``[Q]`` per-query external bounds — they prune the
    scan but are never returned as answers.
    ``mindist_fn``: injectable lower bound with the batched signature
    ``(q_paas [Q, w], codes [B, w]) -> [Q, B]`` (tensors on the
    partition's device); defaults to :func:`repro_torch.kernels.ops.
    mindist_batch`.
    ``scan_mode``: None (the eager chain) or ``"kernel"`` (the fused
    ``scan_verify`` on device-backed partitions: the CUDA kernel on a CUDA
    partition, its plain twin on a CPU one; segments stay eager).
    """
    queries_np = _queries_np(queries)
    return _execute(plan, queries_np, _new_stats(len(queries_np), True),
                    k=k, bsf=bsf, radius_leaves=radius_leaves, chunk=chunk,
                    io=io, mindist_fn=mindist_fn, scan_mode=scan_mode)


def _new_stats(nq: int, exact: bool) -> SearchStats:
    stats = SearchStats(exact=exact, queries=nq)
    stats.candidates_per_query = np.zeros(nq, np.int64)
    stats.leaves_per_query = np.zeros(nq, np.int64)
    return stats


def _plan(partitions: Sequence[Partition], queries_np: np.ndarray,
          cfg: S.SummaryConfig, stats: SearchStats, *,
          ts_min: Optional[int], temporal_prune: bool, io) -> ScanPlan:
    """The ``plan`` stage: the queries' PAA and :func:`build_plan`.  The
    plan is priced on the host from the PAA (the same numbers on any
    device)."""
    with stage(stats, "plan", queries=len(queries_np)) as sp:
        q_paas = S.paa(torch.from_numpy(queries_np), cfg.segments).numpy()
        plan = build_plan(partitions, q_paas, ts_min=ts_min,
                          temporal_prune=temporal_prune, io=io)
        sp.set(partitions=plan.n_partitions,
               buffers=sum(not e.partition.is_sorted for e in plan.entries),
               window_dropped=plan.window_dropped)
    return plan


def _execute(plan: ScanPlan, queries_np: np.ndarray, stats: SearchStats, *,
             k: int, bsf: Optional[np.ndarray], radius_leaves: int,
             chunk: int, io, mindist_fn, scan_mode: Optional[str]
             ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    if scan_mode not in SCAN_MODES:
        raise ValueError(f"scan_mode must be one of {SCAN_MODES}, "
                         f"got {scan_mode!r}")
    nq = queries_np.shape[0]
    pool = KnnPool(nq, k, ext=bsf)
    live_pairs = 0
    total_rows = 0
    on_device = {}
    t_scan = time.perf_counter()
    for pi, entry in enumerate(plan.entries):
        part = entry.partition
        label = f"p{pi}:{part.kind}"
        dev = part.device
        if dev not in on_device:
            on_device[dev] = (torch.as_tensor(queries_np, device=dev),
                              torch.as_tensor(plan.q_paas, device=dev))
        queries_t, q_paas_t = on_device[dev]
        b_syncs = stats.host_syncs
        if not part.is_sorted:
            with _span("scan", part=label, rows=part.n) as sp:
                before_rows = stats.buffer_rows
                _scan_buffer(entry, queries_t, k, pool, stats, io)
                sp.set(buffer_rows=stats.buffer_rows - before_rows,
                       host_syncs=stats.host_syncs - b_syncs)
            continue
        part_mindist = (_default_mindist(part.cfg) if mindist_fn is None
                        else mindist_fn)
        total_rows += part.n
        pruned_before = stats.partitions_pruned
        # scan-span attrs are deltas of the SAME stats counters, so the
        # per-span numbers sum to the SearchStats totals by construction
        b_scanned, b_pruned = stats.leaves_scanned, stats.leaves_pruned
        b_bytes, b_cand = stats.scan_bytes, stats.candidates
        with _span("scan", part=label, rows=part.n,
                   leaves=part.n_leaves) as sp:
            live, groups, device_pool = _scan_sorted(
                entry, queries_t, q_paas_t, k, pool, stats,
                radius_leaves=radius_leaves, chunk=chunk, io=io,
                mindist_fn=part_mindist,
                fused=scan_mode == "kernel" and part.backend == "device",
                label=label)
            live_pairs += live
            sp.set(device_pool=device_pool, groups=groups,
                   leaves_scanned=stats.leaves_scanned - b_scanned,
                   leaves_pruned=stats.leaves_pruned - b_pruned,
                   scan_bytes=stats.scan_bytes - b_bytes,
                   candidates=stats.candidates - b_cand,
                   host_syncs=stats.host_syncs - b_syncs)
        if stats.partitions_pruned == pruned_before:
            stats.partitions_touched += 1
    stats.add_timing("scan", _ms_since(t_scan))
    stats.pruned_frac = 1.0 - live_pairs / max(nq * total_rows, 1)
    best_d, best_off = pool.result()
    record_search(stats)
    return best_d, best_off, stats


def exact_knn(partitions: Sequence[Partition], queries,
              cfg: S.SummaryConfig, *, k: int = 1,
              ts_min: Optional[int] = None, temporal_prune: bool = True,
              bsf: Optional[np.ndarray] = None, radius_leaves: int = 1,
              chunk: int = 4096, io=None, mindist_fn=None,
              scan_mode: Optional[str] = None
              ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Plan + execute in one call — the pipeline every exact-search entry
    point delegates to."""
    queries_np = _queries_np(queries)
    stats = _new_stats(len(queries_np), True)
    plan = _plan(partitions, queries_np, cfg, stats, ts_min=ts_min,
                 temporal_prune=temporal_prune, io=io)
    return _execute(plan, queries_np, stats, k=k, bsf=bsf,
                    radius_leaves=radius_leaves, chunk=chunk, io=io,
                    mindist_fn=mindist_fn, scan_mode=scan_mode)
