"""k-NN pool merging, cross-partition bsf chaining, and query accounting.

The merger is the only piece of the pipeline that holds query *state*:
a :class:`KnnPool` carries the per-query ``[Q, k]`` best-so-far pools
(plus an optional external bound — the sharded router's cross-shard
chain), and :class:`SearchStats` carries the paper's query-cost
accounting, now with leaf-granular fields (``leaves_pruned`` /
``leaves_scanned``) from the planner's fence bounds.

Tie-breaking contract (shared by every entry point): pools are merged
with a *stable* sort and deduplicated by reported id keeping the
earliest pool entry, matching the strict ``d < bsf`` update rule of the
historical single-query chain — so answers are identical whether rows
arrive from one partition or many, in any visit order, for any batch
size.

A :class:`DeviceKnnPool` holds a :class:`KnnPool`'s pools on a partition's
device while the exact scan walks that partition's leaf groups: the
``pool_merge`` kernel folds each group in under the same contract, so the
scan never waits for the card, and the pools come back to the host pool
once, at the partition's end.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops

__all__ = ["SearchStats", "KnnPool", "DeviceKnnPool", "merge_topk",
           "merge_pools"]


@dataclasses.dataclass
class SearchStats:
    """Per-query accounting for the paper's query-cost experiments.

    The batched entry points return ONE SearchStats for the whole batch
    (``queries`` > 1).  Batch-level totals and per-query breakdowns are
    BOTH reported so per-query cost is never conflated across the batch:
    ``candidates`` counts distinct raw rows fetched (shared across the
    batch), ``pruned_frac`` is the fraction of (query, row) pairs the
    lower bound discarded, ``leaves_touched`` counts distinct leaf
    blocks in the union of all queries' candidate sets, and
    ``candidates_per_query`` / ``leaves_per_query`` are ``[Q]`` arrays
    attributing verified rows and touched leaves to each individual
    query (for Q=1 they reduce to the scalar totals).

    Leaf-granular planner accounting: ``leaves_scanned`` counts leaves
    whose code block was actually streamed, ``leaves_pruned`` counts
    leaves skipped whole by their z-order fence mindist bound (including
    all leaves of whole-pruned partitions) — the skip-sequential scan's
    observability.

    Budgeted (approximate) scans additionally report the gap contract:
    ``gap`` is a ``[Q]`` array such that the true exact k-th distance is
    >= the returned k-th distance minus ``gap[q]`` (0 certifies the
    answer exact for that query); ``lb_unvisited`` is the ``[Q]``
    smallest mindist over leaves the budget left unvisited (inf when
    every leaf was either scanned or provably pruned);
    ``budget_exhausted`` records whether the drain stopped on the budget
    rather than on the bounds; ``scan_bytes`` counts the code + raw
    bytes the leaf scan streamed (the currency of ``max_bytes``,
    identical across backends — seeds and buffer scans are uncharged).

    ``host_syncs`` counts the search's round trips: each result tensor
    the pipeline turned into a host array or scalar and waited for (a
    bound, a verification, a seed window and its distances, a buffer
    scan's top-k), counted on the CPU as on the card.  Host copies cached
    once per source (a tree's fences, ids and timestamps) and the
    caller's queries are not counted.
    """
    candidates: int = 0          # raw series whose true ED was computed
    pruned_frac: float = 0.0     # fraction of (query, row) pairs pruned
    leaves_touched: int = 0      # distinct leaf blocks with verified rows
    exact: bool = True
    queries: int = 1             # batch size this accounting covers
    candidates_per_query: Optional[np.ndarray] = None   # [Q] rows verified
    leaves_per_query: Optional[np.ndarray] = None       # [Q] leaves touched
    shards_touched: int = 0      # shards actually searched (sharded engine)
    shards_pruned: int = 0       # shards skipped by key-fence mindist bound
    leaves_scanned: int = 0      # leaf blocks whose codes were streamed
    leaves_pruned: int = 0       # leaf blocks skipped by fence mindist
    partitions_touched: int = 0  # sorted partitions actually scanned
    partitions_pruned: int = 0   # sorted partitions skipped whole by fence
    buffer_rows: int = 0         # unsorted buffer rows brute-force scanned
    scan_bytes: int = 0          # code+raw bytes streamed by the leaf scan
    budget_exhausted: bool = False   # drain stopped on the budget
    gap: Optional[np.ndarray] = None          # [Q] certified epsilon bound
    lb_unvisited: Optional[np.ndarray] = None  # [Q] min unvisited-leaf lb
    # Observability riders (never affect answers): per-stage wall times,
    # the touched leaf ids per partition (capped), for the query log, and
    # the device-to-host conversions the search waited for.
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    leaf_touches: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)

    host_syncs: int = 0

    LEAF_TOUCH_CAP = 64   # max touched-leaf ids kept per partition

    def add_timing(self, stage: str, ms: float) -> None:
        self.timings[stage] = self.timings.get(stage, 0.0) + ms

    def touch_leaves(self, part: str, leaf_ids) -> None:
        """Record which leaves of ``part`` were actually streamed
        (capped at ``LEAF_TOUCH_CAP`` per partition — the query log
        drives hot-leaf analysis, not exact replay)."""
        cur = self.leaf_touches.setdefault(part, [])
        room = self.LEAF_TOUCH_CAP - len(cur)
        if room > 0:
            cur.extend(int(i) for i in list(leaf_ids)[:room])

    def merge(self, other: "SearchStats") -> None:
        """Fold another pipeline invocation's accounting into this one
        (the sharded engine sums per-shard stats)."""
        self.candidates += other.candidates
        self.leaves_touched += other.leaves_touched
        self.leaves_scanned += other.leaves_scanned
        self.leaves_pruned += other.leaves_pruned
        self.partitions_touched += other.partitions_touched
        self.partitions_pruned += other.partitions_pruned
        self.buffer_rows += other.buffer_rows
        self.scan_bytes += other.scan_bytes
        self.host_syncs += other.host_syncs
        self.budget_exhausted = (self.budget_exhausted
                                 or other.budget_exhausted)
        for stage, ms in other.timings.items():
            self.add_timing(stage, ms)
        for part, ids in other.leaf_touches.items():
            self.touch_leaves(part, ids)


def merge_topk(dists: np.ndarray, offsets: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k of a candidate pool, dedup'd by offset (same row may appear
    in both the approximate seed window and the verified set).  Stable:
    on equal distances the earlier pool entry wins, matching the strict
    ``d < bsf`` update rule of the single-query path.  Pads to k with
    (inf, -1)."""
    offsets = np.asarray(offsets)
    dists = np.asarray(dists, np.float32)
    _, first = np.unique(offsets, return_index=True)
    first.sort()                       # keep original pool order
    d, o = dists[first], offsets[first]
    sel = np.argsort(d, kind="stable")[:k]
    out_d = np.full(k, np.inf, np.float32)
    out_o = np.full(k, -1, np.int64)
    out_d[: len(sel)] = d[sel]
    out_o[: len(sel)] = o[sel]
    return out_d, out_o


def merge_pools(cur_d: np.ndarray, cur_off: np.ndarray,
                new_d: np.ndarray, new_off: np.ndarray, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two per-query ``[Q, k]`` pools.  No id dedup needed: every
    row lives in exactly one component, so its global id appears in at
    most one pool.  Stable sort keeps the earlier (current-pool) entry
    on ties, matching the strict ``d < bsf`` rule of the single-query
    chain."""
    d = np.concatenate([cur_d, new_d], axis=1)
    off = np.concatenate([cur_off, new_off], axis=1)
    sel = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(d, sel, axis=1),
            np.take_along_axis(off, sel, axis=1))


class KnnPool:
    """Per-query best-so-far pools plus the external bsf chain.

    ``bound()`` is the pruning bound the scan compares mindists against:
    the per-query minimum of the pool's k-th best and the external bound
    (which prunes but is never returned as an answer — a caller chaining
    components keeps its own best and compares)."""

    def __init__(self, nq: int, k: int,
                 ext: Optional[np.ndarray] = None):
        self.k = k
        self.best_d = np.full((nq, k), np.inf, np.float32)
        self.best_off = np.full((nq, k), -1, np.int64)
        self.ext = (np.full(nq, np.inf, np.float32) if ext is None
                    else np.asarray(ext, np.float32))

    def bound(self) -> np.ndarray:
        """[Q] pruning bound: min(k-th best, external bsf)."""
        return np.minimum(self.best_d[:, -1], self.ext)

    def update(self, qi: int, dists: np.ndarray, offsets: np.ndarray
               ) -> None:
        """Fold candidates for one query into its pool (dedup by id)."""
        self.best_d[qi], self.best_off[qi] = merge_topk(
            np.concatenate([self.best_d[qi], dists]),
            np.concatenate([self.best_off[qi], offsets]), self.k)

    def update_batch(self, new_d: np.ndarray, new_off: np.ndarray) -> None:
        """Fold disjoint per-query ``[Q, k]`` pools in (no id overlap)."""
        self.best_d, self.best_off = merge_pools(
            self.best_d, self.best_off, new_d, new_off, self.k)

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.best_d, self.best_off


class DeviceKnnPool:
    """A :class:`KnnPool`'s pools on one partition's device, and what the
    partition's scan touched, accumulated there.

    Loaded from the host pool once (after the partition's seed and fence
    pruning), folded into by :meth:`fold` once a leaf group, and stored
    back into the host pool by :meth:`store`, the one copy back.  Besides
    ``best_d [Q, k]``, ``best_off [Q, k]`` and ``ext [Q]`` it keeps the
    per-query live counts, a mark per verified row (``row_mark``, padded to
    whole leaves) and a mark per (query, leaf) with a live row.  The
    pruning bound, min(k-th best, external bsf), is read on the card by
    the fold itself."""

    def __init__(self, pool: KnnPool, device: torch.device, *,
                 n_leaves: int, leaf_size: int):
        nq = pool.best_d.shape[0]
        self.leaf_size = leaf_size
        self.best_d = torch.tensor(pool.best_d, device=device)
        self.best_off = torch.tensor(pool.best_off, device=device)
        self.ext = torch.tensor(pool.ext, device=device)
        self.counts = torch.zeros(nq, dtype=torch.int64, device=device)
        self.row_mark = torch.zeros(n_leaves * leaf_size, dtype=torch.uint8,
                                    device=device)
        self.leaf_mark = torch.zeros((nq, n_leaves), dtype=torch.uint8,
                                     device=device)

    def fold(self, md: torch.Tensor, dd: torch.Tensor, leaves: torch.Tensor,
             dead: Optional[torch.Tensor], ids: torch.Tensor) -> None:
        """Fold one leaf group in: ``md``/``dd`` ``[Q, B]`` its bound and
        cross ED, row ``j`` row ``j % leaf`` of leaf ``leaves[j // leaf]``;
        ``dead``/``ids`` the partition's dead-row mask and report ids."""
        ops.pool_merge(md, dd, leaves, self.leaf_size, dead, ids,
                       self.best_d, self.best_off, self.ext, self.counts,
                       self.row_mark, self.leaf_mark)

    def store(self, pool: KnnPool) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        """Write the pools back into ``pool`` in one copy to the host.
        Returns ``(live [Q], leaves [Q], verified [n_leaves])``: each
        query's live rows and touched leaves, and each leaf's verified
        rows (rows live for any query)."""
        nq, k = self.best_d.shape
        n_leaves = self.leaf_mark.shape[1]
        ints = torch.cat([
            self.best_off.reshape(-1), self.counts,
            self.leaf_mark.sum(1, dtype=torch.int64),
            self.row_mark.view(n_leaves, self.leaf_size).sum(
                1, dtype=torch.int64)])
        host = torch.cat([ints.view(torch.uint8),
                          self.best_d.reshape(-1).view(torch.uint8)]).cpu()
        raw = host.numpy()
        ints = raw[:ints.numel() * 8].view(np.int64)
        pool.best_off = ints[:nq * k].reshape(nq, k).copy()
        pool.best_d = raw[ints.nbytes:].view(np.float32).reshape(nq, k).copy()
        live = ints[nq * k:nq * k + nq]
        leaves = ints[nq * k + nq:nq * k + 2 * nq]
        return live, leaves, ints[nq * k + 2 * nq:]
