"""Immutable read views over a Coconut-LSM: search without stopping ingest.

A :class:`Snapshot` captures, under the engine lock, (a) the run list as a
tuple, (b) the logical clock, and (c) optionally a *frozen copy* of the
insert buffer (including batches currently being flushed by the
compactor).  Runs are immutable once published and the buffer copy is
private, so every ``search_*`` below executes against a consistent,
point-in-time view while flushes and merges swap the live run list
underneath — readers never block writers and vice versa.

Every exact search delegates to the unified query pipeline
(:mod:`repro_torch.query`): the runs and the frozen buffer become
:class:`~repro_torch.query.partition.Partition` objects, the planner applies
the window cut (BTP/TP run skipping, row-level ``ts_min`` for
straddling runs, PP post-filtering) and prices every run and leaf with
z-order fence bounds, and the executor scans the surviving leaves with
one shared best-so-far chain.

Exactness is partition-independent: an exact query verifies true
Euclidean distances over every qualifying row, so its answer *distances*
are bit-identical whether a row sits in a level-3 run, a fresh level-0
run, or the frozen buffer (the buffer is copied to the engine's device
and scanned brute-force with the cross form of the ``batch_euclid``
kernel the SIMS verifier uses, whose lane order gives a pair the same
bits on every path).  That is what lets
the concurrent engine return the same answers as the synchronous one at
every interleaving point — and what lets the sharded router return the
same answers for any shard count.  Answers report *global row ids* (the
row's absolute position in the insert stream), which the engine threads
through runs and the frozen buffer alike, so the reported neighbor is
unambiguous across runs, shards, and restarts.

Every exact entry point accepts an external ``bsf`` bound (the sharded
router's best-so-far chain): it prunes the scan but is never returned as
an answer.  ``key_fence`` carries the z-order key range of everything the
snapshot can see (runs + frozen buffer), letting the router skip whole
shards whose fence mindist bound cannot beat the chain's bsf.

The single-query entry points are thin wrappers over the batched ones
(Q=1) returning length-k arrays.  The runs' trees live on the engine's
device (the card unless the engine was made with ``device="cpu"``); the
frozen buffer stays on the host and is copied to that device per scan.
An engine with a store and ``tiers=`` hands its snapshots the tiered leaf
store: each committed run is then read off its segment file through the
cache (its v3 code blocks reach ``unpack_mindist``, hot ones from the
card), with the same answer bits as the run's tree, and whole exact
probes are served from the result cache, keyed as the reference keys it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import summarization as S
from ..core.metrics import IOStats
from ..query import Partition, exact_knn
from ..query.executor import _queries_np
from ..query.merger import SearchStats

__all__ = ["Snapshot", "FrozenBuffer"]


@dataclasses.dataclass(frozen=True)
class FrozenBuffer:
    """Point-in-time copy of the not-yet-flushed insert tail."""
    raw: np.ndarray                    # [M, L] float32, insertion order
    ts: np.ndarray                     # [M] int64
    ids: np.ndarray                    # [M] int64 global row ids

    @property
    def n(self) -> int:
        return len(self.raw)


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Consistent read view: frozen run tuple + optional frozen buffer."""
    runs: Tuple                        # Tuple[Run, ...], newest first
    clock: int
    mode: str                          # "pp" | "tp" | "btp"
    io: Optional[IOStats] = None
    buffer: Optional[FrozenBuffer] = None
    key_fence: Optional[Tuple[int, int]] = None   # (lo, hi) z-order bigints
    cfg: Optional[S.SummaryConfig] = None
    # TieredLeafStore shared with the engine: run partitions then read
    # leaf blocks through the cache (and probe the query-result cache)
    tiers: Optional[object] = None
    # engine data-visibility epoch at capture time — the result-cache
    # key component that makes answers from any older view unreachable
    epoch: int = 0
    # engine identity (store root): one TieredLeafStore may back many
    # engines (the sharded router shares one across shards), and two
    # engines can hold the same epoch value — the scope keeps their
    # result-cache entries apart
    scope: Optional[str] = None
    # where the buffer's brute-force scan runs (the runs' trees carry
    # their own device); None: the card
    device: Optional[torch.device] = None

    @property
    def n(self) -> int:
        return (sum(r.n for r in self.runs)
                + (self.buffer.n if self.buffer else 0))

    def _cfg(self) -> S.SummaryConfig:
        if self.cfg is not None:
            return self.cfg
        return self.runs[0].tree.cfg

    # ------------------------------------------------------------- qualifying
    def _ts_min(self, window: Optional[int]) -> Optional[int]:
        return None if window is None else self.clock - window

    # ------------------------------------------------------------- partitions
    def _partitions(self):
        """The pipeline view of everything this snapshot can see: the
        frozen buffer (newest rows, brute-force scanned) + one partition
        per run, window-qualified and leaf-priced by the planner."""
        parts = []
        if self.buffer is not None and self.buffer.n:
            parts.append(Partition.from_buffer(self.buffer, self._cfg(),
                                               device=self.device))
        for r in self.runs:
            seg = getattr(r, "seg_handle", None)
            if self.tiers is not None and seg is not None:
                # tiered backend: the run's committed segment file, read
                # leaf-by-leaf through the cache — answers bit-identical
                # to the device tree view (cross-backend parity)
                parts.append(Partition.from_segment(
                    seg, ts_range=(r.t_min, r.t_max), tiers=self.tiers,
                    device=self.device))
            else:
                parts.append(Partition.from_run(r))
        return parts

    # ----------------------------------------------------------- single query
    def search_approx(self, query: np.ndarray, *,
                      k: int = 1,
                      window: Optional[int] = None,
                      radius_leaves: int = 1,
                      budget=None
                      ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Approximate k-NN over the qualifying runs (Algorithm 4 per run)
        plus the frozen buffer; Q=1 wrapper over the batched path
        returning length-k arrays."""
        q = _queries_np(query)[:1]
        d, off, info = self.search_approx_batch(
            q, k=k, window=window, radius_leaves=radius_leaves,
            budget=budget)
        return d[0], off[0], info

    def search_exact(self, query: np.ndarray, *,
                     k: int = 1,
                     window: Optional[int] = None,
                     radius_leaves: int = 1,
                     bsf: Optional[float] = None,
                     budget=None,
                     mode: str = "exact"
                     ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Exact k-NN over the snapshot; Q=1 wrapper over the batched
        path returning length-k arrays.  ``bsf`` seeds the chain with an
        external bound (shard chaining) — it prunes but is never
        returned.  ``budget``/``mode`` select the budgeted drain (see
        :meth:`search_exact_batch`)."""
        q = _queries_np(query)[:1]
        ext = None if bsf is None else np.asarray([bsf], np.float32)
        d, off, info = self.search_exact_batch(
            q, k=k, window=window, radius_leaves=radius_leaves, bsf=ext,
            budget=budget, mode=mode)
        return d[0], off[0], info

    # -------------------------------------------------------- batched queries
    def search_approx_batch(self, queries: np.ndarray, *,
                            k: int = 1,
                            window: Optional[int] = None,
                            radius_leaves: int = 1,
                            budget=None
                            ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Batched approximate k-NN through the shared budgeted executor
        (:mod:`repro_torch.query.approx`): the frozen buffer is brute-force
        scanned and every qualifying run contributes its Algorithm-4
        seed probe; with the default zero-leaf budget nothing else is
        scanned — the historical "probe each run" behavior, now with a
        certified ``gap`` report in the info dict.  Pass a
        :class:`repro_torch.query.Budget` (or int = max scanned leaves) to
        spend more and tighten the gap.

        Returns (dists ``[Q, k]``, ids ``[Q, k]``, info).
        """
        from ..query import Budget, as_budget
        if budget is None:
            budget = Budget(max_leaves=0)
        return self.search_exact_batch(
            queries, k=k, window=window, radius_leaves=radius_leaves,
            budget=as_budget(budget), mode="approx")

    def search_exact_batch(self, queries: np.ndarray, *,
                           k: int = 1,
                           window: Optional[int] = None,
                           radius_leaves: int = 1,
                           bsf: Optional[np.ndarray] = None,
                           budget=None,
                           mode: str = "exact"
                           ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Batched exact k-NN through the unified pipeline: the planner
        window-qualifies the runs and prices every leaf with its z-order
        fence bound, the executor scans surviving leaves cheapest-first
        with ONE shared per-query best-so-far chain (vs Q scans in the
        single-query loop), and the merger owns the cross-partition
        top-k.

        ``bsf``: optional ``[Q]`` external per-query bounds (the sharded
        router's cross-shard chain) — combined with the internal
        k-th-best bound for pruning on every scan, never returned as an
        answer.
        ``budget`` / ``mode="approx"``: drain the best-first leaf
        frontier under a :class:`repro_torch.query.Budget` instead of scanning
        every surviving leaf; the info dict gains ``gap`` /
        ``lb_unvisited`` / ``budget_exhausted`` (gap contract in
        :mod:`repro_torch.query.approx`).  Unlimited budget returns the exact
        bits with ``gap == 0``.
        """
        from ..obs import probe
        from ..query import approx_knn, as_budget
        queries = _queries_np(queries)
        if mode not in ("exact", "approx"):
            raise ValueError(
                f"mode must be 'exact' or 'approx', got {mode!r}")
        kw = dict(k=k, ts_min=self._ts_min(window),
                  temporal_prune=(self.mode != "pp"),
                  bsf=bsf, radius_leaves=radius_leaves, io=self.io)
        budgeted = budget is not None or mode == "approx"
        # whole-probe result cache: only unbudgeted exact probes without
        # an external bound are cacheable (a bsf chain or budget changes
        # what the probe may return).  Keyed by the raw query bytes (the
        # PAA derives from them, but PAA alone would alias distinct
        # queries with equal summaries onto one answer), the window cut,
        # k, the seed radius, and the snapshot's data epoch — any
        # flush/merge/rebalance bumps the epoch, so a stale answer is
        # unreachable by construction.
        ckey = None
        if (self.tiers is not None and not budgeted and bsf is None):
            ckey = (queries.tobytes(), queries.shape, window, k,
                    radius_leaves, int(self.epoch), self.mode,
                    self.scope)
            hit = self.tiers.result_get(ckey)
            if hit is not None:
                best_d, best_off, info = hit
                # the cached probe is logged (records/queries stay in
                # step with query.probes_total) but carries NO "stats":
                # no pipeline ran, so the registry's query.* totals were
                # not advanced and the analytics bit-exact certification
                # still holds
                with probe("snapshot.exact", queries=queries.shape[0],
                           k=k, window=window,
                           snapshot_epoch=int(self.clock)) as rec:
                    rec["result_cache"] = "hit"
                return best_d.copy(), best_off.copy(), dict(info)
        with probe("snapshot." + ("approx" if budgeted else "exact"),
                   queries=queries.shape[0], k=k, window=window,
                   budget=as_budget(budget) if budgeted else None,
                   snapshot_epoch=int(self.clock)) as rec:
            if budgeted:
                best_d, best_off, stats = approx_knn(
                    self._partitions(), queries, self._cfg(),
                    budget=budget, **kw)
            else:
                best_d, best_off, stats = exact_knn(
                    self._partitions(), queries, self._cfg(), **kw)
            rec["stats"] = stats
        info = self._info(stats)
        if ckey is not None:
            self.tiers.result_put(ckey, (best_d.copy(), best_off.copy(),
                                         info))
        return best_d, best_off, info

    @staticmethod
    def _info(stats: SearchStats) -> dict:
        """The dict contract the engines/tests read, derived from the
        pipeline's SearchStats (``candidates`` includes the brute-forced
        buffer rows, matching the historical accounting).  Budgeted
        searches add the gap-report keys."""
        info = {"partitions_touched": stats.partitions_touched,
                "partitions_pruned": stats.partitions_pruned,
                "candidates": stats.candidates + stats.buffer_rows,
                "candidates_per_query": stats.candidates_per_query,
                "leaves_per_query": stats.leaves_per_query,
                "leaves_pruned": stats.leaves_pruned,
                "leaves_scanned": stats.leaves_scanned,
                "buffer_rows": stats.buffer_rows,
                "stats": stats}
        if stats.gap is not None:
            info["gap"] = stats.gap
            info["lb_unvisited"] = stats.lb_unvisited
            info["budget_exhausted"] = stats.budget_exhausted
        return info
