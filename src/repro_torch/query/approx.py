"""Budgeted approximate search: best-first frontier drain + gap report.

The exact executor already prices every leaf of every sorted partition
with a z-order envelope mindist bound (:mod:`repro_torch.query.planner`).
This module turns those bounds into a recall/latency dial: instead of
scanning every surviving leaf, the drain visits leaves **best-first**
(smallest bound over the batch first) and stops when a per-query budget
runs out —

* ``max_leaves``: at most that many leaf blocks streamed (exact
  compliance: admission is checked leaf by leaf);
* ``max_bytes``: at most that many code+raw bytes streamed by the leaf
  scan (a conservative whole-leaf projection gates admission, so the
  actual spend never exceeds the budget; the charge is computed from
  shapes, identical across backends and to the reference's);
* ``deadline_ms``: wall-clock cutoff checked between verification
  groups (the only budget kind whose scanned set varies run to run).

Seed probes (Algorithm 4) and unsorted-buffer scans always run and are
never charged — a zero budget returns seed+buffer answers, keeping the
k-th distance finite so the gap report stays meaningful.

**Gap contract.**  Every answer ships a per-query certified bound::

    exact_kth >= returned_kth - gap[q]

``gap[q] = max(0, returned_kth - lb_unvisited[q])`` where
``lb_unvisited[q]`` is the smallest envelope mindist over *all* leaves
not actually scanned; leaves discarded by the fence bound satisfy
``lb >= bound`` at discard time, so with no external ``bsf`` they can
never contribute a positive gap — an unlimited budget therefore reports
``gap == 0`` exactly and the answer is certified exact (``stats.exact``).

**Determinism and monotonicity.**  The frontier is sorted on the host by
``(min-over-queries leaf bound, plan entry order, leaf index)`` with a
stable sort, admission stops at the *first* rejected leaf, and every
admitted group goes through the exact path's eager chain
(``mindist_batch`` or ``unpack_mindist``, then the cross form of
``batch_euclid``) — so the leaves scanned under a smaller budget are a
prefix of those under a larger one, answers never get worse as the
budget grows (deadline budgets excepted), and an unlimited budget gives
the exact path's bits.

:func:`progressive_knn` exposes the drain as a generator that yields an
improving ``(dists, ids, stats)`` snapshot after the seeds and after
every verification group.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import summarization as S
from ..obs import record_search, span as _span
from .executor import (_default_mindist, _leaves_per_group, _ms_since,
                       _queries_np, _scan_buffer, _scan_leaf_group,
                       _seed_sorted)
from .merger import KnnPool, SearchStats
from .partition import Partition
from .planner import ScanPlan, build_plan

__all__ = ["Budget", "as_budget", "approx_knn", "certified_gap",
           "progressive_knn"]


def certified_gap(kth: np.ndarray, lb_unvisited: np.ndarray) -> np.ndarray:
    """``gap[q] = max(0, kth[q] - lb_unvisited[q])`` with the two inf
    conventions the drain produces: ``lb == inf`` means every leaf was
    visited (gap 0 even when fewer than k rows exist, so ``kth`` may be
    inf too), and ``kth == inf`` against a finite ``lb`` means fewer
    than k rows were seen while unvisited leaves remain — the gap is
    honestly unbounded (inf)."""
    kth = np.asarray(kth, np.float32)
    lb_unvisited = np.asarray(lb_unvisited, np.float32)
    gap = np.zeros(kth.shape, np.float32)
    m = ~np.isinf(lb_unvisited)
    if m.any():
        gap[m] = np.maximum(np.float32(0.0), kth[m] - lb_unvisited[m])
    return gap


@dataclasses.dataclass(frozen=True)
class Budget:
    """Per-query scan budget; ``None`` fields are unlimited.

    Multiple limits compose conjunctively — the drain stops at the
    first one hit.  ``Budget()`` is the unlimited budget: the drain
    visits every surviving leaf and the answer is certified exact
    (``gap == 0``), bit-identical to the exact pipeline.
    """
    max_leaves: Optional[int] = None     # leaf blocks streamed
    max_bytes: Optional[int] = None      # code+raw bytes streamed
    deadline_ms: Optional[float] = None  # wall-clock cutoff

    @property
    def unlimited(self) -> bool:
        return (self.max_leaves is None and self.max_bytes is None
                and self.deadline_ms is None)


def as_budget(budget: Union[None, int, dict, Budget]) -> Optional[Budget]:
    """Normalize the ``budget=`` kwarg every entry point accepts:
    ``None`` (unlimited), an int (shorthand for ``max_leaves``), a dict
    of :class:`Budget` fields, or a :class:`Budget`."""
    if budget is None or isinstance(budget, Budget):
        return budget
    if isinstance(budget, dict):
        return Budget(**budget)
    return Budget(max_leaves=int(budget))


def _drain(plan: ScanPlan, queries_np: np.ndarray, *, k: int,
           budget: Optional[Budget], bsf, radius_leaves: int,
           chunk: int, io, mindist_fn, plan_ms: float = 0.0
           ) -> Iterator[Tuple[np.ndarray, np.ndarray, SearchStats]]:
    """The budgeted frontier drain (generator of improving snapshots)."""
    nq = queries_np.shape[0]
    on_device = {}

    def on(dev):
        if dev not in on_device:
            on_device[dev] = (torch.as_tensor(queries_np, device=dev),
                              torch.as_tensor(plan.q_paas, device=dev))
        return on_device[dev]

    pool = KnnPool(nq, k, ext=bsf)
    stats = SearchStats(exact=False, queries=nq)
    stats.candidates_per_query = np.zeros(nq, np.int64)
    stats.leaves_per_query = np.zeros(nq, np.int64)
    if plan_ms:
        stats.add_timing("plan", plan_ms)
    budget = budget if budget is not None else Budget()
    t_end = None
    if budget.deadline_ms is not None:
        t_end = time.perf_counter() + budget.deadline_ms / 1e3
    leaf_cap = (np.inf if budget.max_leaves is None
                else int(budget.max_leaves))
    byte_cap = (np.inf if budget.max_bytes is None
                else int(budget.max_bytes))

    # buffers are brute-force scanned up front, uncharged: they have no
    # fences to bound them, so skipping them would poison the gap
    sorted_entries = []
    for entry in plan.entries:
        if entry.partition.is_sorted:
            sorted_entries.append(entry)
        else:
            _scan_buffer(entry, on(entry.partition.device)[0], k, pool,
                         stats, io)

    # seed every sorted partition (Algorithm 4 probes, uncharged)
    seeded = []
    total_rows = 0
    t0 = time.perf_counter()
    for entry in sorted_entries:
        with _span("seed", radius_leaves=radius_leaves):
            alive, offs_all, idx0 = _seed_sorted(
                entry, on(entry.partition.device)[0], pool,
                radius_leaves=radius_leaves, io=io)
        stats.candidates += len(np.unique(idx0))
        stats.candidates_per_query += idx0.shape[1]
        stats.partitions_touched += 1
        total_rows += entry.partition.n
        seeded.append((alive, offs_all))
    if sorted_entries:
        stats.add_timing("seed", _ms_since(t0))

    # global frontier: every leaf of every sorted partition, keyed by
    # its cheapest per-query bound; stable tie-break on (entry, leaf)
    nl = [e.leaf_bounds.shape[1] for e in sorted_entries]
    if nl:
        fent = np.concatenate([np.full(c, i, np.int64)
                               for i, c in enumerate(nl)])
        fleaf = np.concatenate([np.arange(c, dtype=np.int64) for c in nl])
        fkey = np.concatenate([e.leaf_bounds.min(axis=0)
                               for e in sorted_entries])
        order = np.lexsort((fleaf, fent, fkey))
    else:
        fent = fleaf = order = np.zeros(0, np.int64)
        fkey = np.zeros(0, np.float32)
    scanned_mask = [np.zeros(c, bool) for c in nl]
    leaf_marks = [np.zeros((nq, c), bool) for c in nl]
    union_marks = [np.zeros(c, bool) for c in nl]
    per_fn = [_default_mindist(e.partition.cfg) if mindist_fn is None
              else mindist_fn for e in sorted_entries]
    live_total = 0

    def snapshot() -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        lb_un = np.full(nq, np.inf, np.float32)
        for i, e in enumerate(sorted_entries):
            m = ~scanned_mask[i]
            if m.any():
                lb_un = np.minimum(lb_un, e.leaf_bounds[:, m].min(axis=1))
        gap = certified_gap(pool.best_d[:, -1], lb_un)
        st = dataclasses.replace(stats)
        st.candidates_per_query = stats.candidates_per_query.copy()
        st.timings = dict(stats.timings)
        st.leaf_touches = {p: list(v) for p, v in stats.leaf_touches.items()}
        st.leaves_touched = sum(int(u.sum()) for u in union_marks)
        lpq = np.zeros(nq, np.int64)
        for m_ in leaf_marks:
            lpq += m_.sum(axis=1)
        st.leaves_per_query = lpq
        st.gap = gap
        st.lb_unvisited = lb_un
        st.exact = bool(np.all(gap == 0.0))
        st.pruned_frac = 1.0 - live_total / max(nq * total_rows, 1)
        return pool.best_d.copy(), pool.best_off.copy(), st

    yield snapshot()

    t_scan = time.perf_counter()
    try:
        pos, total = 0, len(order)
        while pos < total:
            bound = pool.bound()
            if fkey[order[pos]] >= float(bound.max()):
                # everything left is fence-pruned for every query: with no
                # external bsf these leaves can never contribute to the gap
                with _span("prune", frontier=True) as psp:
                    stats.leaves_pruned += total - pos
                    psp.set(leaves_pruned=total - pos)
                break
            if t_end is not None and time.perf_counter() >= t_end:
                stats.budget_exhausted = True
                break
            ei = int(fent[order[pos]])
            entry = sorted_entries[ei]
            part = entry.partition
            queries_t, q_paas_t = on(part.device)
            label = f"p{ei}:{part.kind}"
            cap = _leaves_per_group(chunk, nq, part.leaf_size)
            # conservative whole-leaf byte projection (codes + raw rows),
            # the reference's to the byte
            proj = part.leaf_size * (part.cfg.segments
                                     + part.cfg.series_len * 4)
            grp = []
            stop = False
            # span attrs are deltas of the SAME stats counters the group
            # charges, so per-span numbers sum to the SearchStats totals
            b_scanned, b_pruned = stats.leaves_scanned, stats.leaves_pruned
            b_bytes, b_cand = stats.scan_bytes, stats.candidates
            with _span("scan", part=label, rows=part.n) as sp:
                while (pos < total and int(fent[order[pos]]) == ei
                       and len(grp) < cap):
                    li = int(fleaf[order[pos]])
                    if not (entry.leaf_bounds[:, li] < bound).any():
                        stats.leaves_pruned += 1
                        pos += 1
                        continue
                    if stats.leaves_scanned + len(grp) + 1 > leaf_cap:
                        stop = True
                        break
                    if stats.scan_bytes + proj * (len(grp) + 1) > byte_cap:
                        stop = True
                        break
                    grp.append(li)
                    pos += 1
                if grp:
                    garr = np.sort(np.asarray(grp, np.int64))  # sequential
                    live, nbytes = _scan_leaf_group(
                        entry, queries_t, q_paas_t, garr, k, pool, stats,
                        seeded[ei][0], seeded[ei][1], leaf_marks[ei],
                        union_marks[ei], io, per_fn[ei], False)
                    live_total += live
                    scanned_mask[ei][garr] = True
                    stats.leaves_scanned += len(garr)
                    stats.scan_bytes += nbytes
                sp.set(leaves_scanned=stats.leaves_scanned - b_scanned,
                       leaves_pruned=stats.leaves_pruned - b_pruned,
                       scan_bytes=stats.scan_bytes - b_bytes,
                       candidates=stats.candidates - b_cand,
                       budget_leaves_left=(
                           None if budget.max_leaves is None
                           else int(leaf_cap - stats.leaves_scanned)),
                       budget_bytes_left=(
                           None if budget.max_bytes is None
                           else int(byte_cap - stats.scan_bytes)))
            if grp:
                yield snapshot()
            if stop:         # admitted leaves scanned; budget is spent
                stats.budget_exhausted = True
                break
    finally:
        # runs on normal drain AND on early consumer close(): the stats
        # that exist at abandon time still reach the registry
        stats.add_timing("scan", _ms_since(t_scan))
        for i, e in enumerate(sorted_entries):
            hit = np.nonzero(union_marks[i])[0]
            if len(hit):
                stats.touch_leaves(f"p{i}:{e.partition.kind}", hit)
        record_search(stats)

    yield snapshot()


def _plan(partitions: Sequence[Partition], queries, cfg: S.SummaryConfig,
          ts_min: Optional[int], temporal_prune: bool, io):
    """(queries as host float32 ``[Q, L]``, plan, plan ms): the plan is
    priced on the host from the queries' PAA, as the exact path's is."""
    queries_np = _queries_np(queries)
    t0 = time.perf_counter()
    q_paas = S.paa(torch.from_numpy(queries_np), cfg.segments).numpy()
    plan = build_plan(partitions, q_paas, ts_min=ts_min,
                      temporal_prune=temporal_prune, io=io)
    return queries_np, plan, _ms_since(t0)


def approx_knn(partitions: Sequence[Partition], queries,
               cfg: S.SummaryConfig, *, k: int = 1,
               budget: Union[None, int, dict, Budget] = None,
               ts_min: Optional[int] = None, temporal_prune: bool = True,
               bsf: Optional[np.ndarray] = None, radius_leaves: int = 1,
               chunk: int = 4096, io=None, mindist_fn=None
               ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Plan + budgeted best-first drain in one call — the approximate
    twin of :func:`repro_torch.query.executor.exact_knn`.  The kernels run
    on each partition's device.

    Returns (dists ``[Q, k]``, ids ``[Q, k]``, stats) where
    ``stats.gap`` certifies ``exact_kth >= dists[:, -1] - gap`` per
    query.  ``budget=None`` drains every surviving leaf: the answer is
    bit-identical to the exact pipeline and ``gap == 0``.
    """
    queries_np, plan, plan_ms = _plan(partitions, queries, cfg, ts_min,
                                      temporal_prune, io)
    out = None
    for out in _drain(plan, queries_np, k=k, budget=as_budget(budget),
                      bsf=bsf, radius_leaves=radius_leaves, chunk=chunk,
                      io=io, mindist_fn=mindist_fn, plan_ms=plan_ms):
        pass
    return out


def progressive_knn(partitions: Sequence[Partition], queries,
                    cfg: S.SummaryConfig, *, k: int = 1,
                    budget: Union[None, int, dict, Budget] = None,
                    ts_min: Optional[int] = None,
                    temporal_prune: bool = True,
                    bsf: Optional[np.ndarray] = None,
                    radius_leaves: int = 1, chunk: int = 4096,
                    io=None, mindist_fn=None
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                        SearchStats]]:
    """Progressive refinement: yield improving ``(dists, ids, stats)``
    snapshots — after the seed/buffer phase and after every verified
    leaf group — until the budget expires or the frontier is drained.

    Each snapshot is safe to keep (arrays are copies) and carries the
    gap report for the rows visited so far; the final snapshot equals
    :func:`approx_knn` with the same arguments bit for bit.  Consumers
    may stop early — the generator abandons the rest of the scan on
    ``close()``.
    """
    queries_np, plan, plan_ms = _plan(partitions, queries, cfg, ts_min,
                                      temporal_prune, io)
    yield from _drain(plan, queries_np, k=k, budget=as_budget(budget),
                      bsf=bsf, radius_leaves=radius_leaves, chunk=chunk,
                      io=io, mindist_fn=mindist_fn, plan_ms=plan_ms)
