"""Leaf-granular scan planning: window filtering + z-order fence bounds.

The planner turns a set of :class:`~repro_torch.query.partition.Partition`
into a :class:`ScanPlan`:

1.  **window / ts_min filtering** — partitions wholly older than the
    window are dropped (BTP/TP run skipping); partitions wholly inside
    keep no ``ts_min`` (no row filter needed); straddling partitions
    carry the cut for row-level post-filtering (and PP mode post-filters
    everything, ``temporal_prune=False``).
2.  **whole-partition fence bounds** — a per-query mindist lower bound
    from the partition's (first key, last key) z-order interval, the
    same internal-node bound the sharded router uses per shard.  The
    executor skips a partition whole when its bound cannot beat the
    live best-so-far chain.
3.  **per-leaf fence bounds** — every leaf's key interval is
    ``[fence_i, fence_{i+1}]`` (leaf-first keys; the partition's last
    key closes the final leaf), a superset of the leaf's keys, so its
    code-envelope mindist lower-bounds every row in the leaf.  The
    executor scans only surviving leaves, cheapest bound first — the
    paper's skip-sequential SIMS discipline at leaf granularity.

The envelope math runs on the host in numpy, as in the reference: keys
in ``[lo, hi]`` share their common bit prefix; interleaved bit ``p = i*w + j`` is bit
``b-1-i`` of segment ``j``, so a prefix of length P pins the top bits
of each segment's code and the free bits span the envelope.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..core import summarization as S
from ..obs import span as _span
from .partition import Partition

__all__ = ["ScanPlan", "ScanEntry", "build_plan", "leaf_envelopes",
           "envelope_mindist_sq"]


def _unpack_key_bits(keys: np.ndarray, used_bits: int) -> np.ndarray:
    """[N, n_words] uint32 big-endian keys -> [N, used_bits] MSB-first."""
    keys = np.ascontiguousarray(keys, np.uint32)
    be = keys.astype(">u4").view(np.uint8).reshape(len(keys), -1)
    return np.unpackbits(be, axis=1)[:, :used_bits]


def leaf_envelopes(fences: np.ndarray, last_key: np.ndarray,
                   cfg: S.SummaryConfig):
    """Per-leaf SAX code envelopes from the leaf fence pointers.

    ``fences``: ``[n_leaves, n_words]`` leaf-first keys (sorted);
    ``last_key``: the partition's last key (closes the final leaf).
    Returns (code_lo ``[n_leaves, w]``, code_hi ``[n_leaves, w]``) — the
    tightest per-segment envelope containing every code word in each
    leaf's key interval.
    """
    w, b = cfg.segments, cfg.bits
    used = w * b
    lo_bits = _unpack_key_bits(fences, used)
    hi_keys = np.concatenate([fences[1:], last_key[None]], axis=0)
    hi_bits = _unpack_key_bits(hi_keys, used)
    diff = lo_bits != hi_bits
    any_diff = diff.any(axis=1)
    prefix = np.where(any_diff, diff.argmax(axis=1), used)   # [n]
    # p = i*w + j  ->  [n, b, w] per-(significance, segment) bit grid
    lo_grid = lo_bits.reshape(-1, b, w).astype(np.int64)
    p_grid = np.arange(b)[:, None] * w + np.arange(w)[None, :]
    known = p_grid[None, :, :] < prefix[:, None, None]       # [n, b, w]
    weight = (1 << (b - 1 - np.arange(b, dtype=np.int64)))[:, None]
    base = (lo_grid * known * weight).sum(axis=1)            # [n, w]
    free = ((~known) * weight).sum(axis=1)                   # [n, w]
    return base, base + free


def envelope_mindist_sq(q_paas: np.ndarray, code_lo: np.ndarray,
                        code_hi: np.ndarray, cfg: S.SummaryConfig
                        ) -> np.ndarray:
    """Squared mindist lower bounds queries x envelopes: ``[Q, n]``.

    <= the true ED^2 to ANY series whose SAX word lies inside the
    (code_lo, code_hi) envelope per segment — hence to any row of the
    leaf (or partition) whose key interval produced the envelope.
    """
    lower, upper = (a.numpy() for a in S.region_bounds(cfg.bits))
    lb = lower[code_lo]                      # [n, w] envelope lower edges
    ub = upper[code_hi]
    q = np.asarray(q_paas, np.float32)[:, None, :]           # [Q, 1, w]
    below = np.where(q < lb[None], lb[None] - q, 0.0)
    above = np.where(q > ub[None], q - ub[None], 0.0)
    d = below + above
    return ((cfg.series_len / cfg.segments)
            * np.sum(d * d, axis=-1)).astype(np.float32)


def _partition_envelopes(part: Partition, io=None):
    """(leaf env_lo, leaf env_hi, partition (lo, hi) envelope) for a
    sorted partition, cached on the immutable source object: fences
    never change for a built tree, so the unpackbits prefix math (and
    the fence copy to the host) happens once per partition, not once
    per query."""
    src = part.source
    key = (part.n, part.leaf_size)
    cached = getattr(src, "_coconut_env_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    fences, last = part.leaf_fences(io=io)
    env_lo, env_hi = leaf_envelopes(fences, last, part.cfg)
    part_env = leaf_envelopes(fences[:1], last, part.cfg)
    out = (env_lo, env_hi, part_env)
    src._coconut_env_cache = (key, out)
    return out


@dataclasses.dataclass
class ScanEntry:
    """One partition's slot in the plan."""
    partition: Partition
    ts_min: Optional[int]          # row-level cut, None when not needed
    part_bound: np.ndarray         # [Q] whole-partition fence mindist
    leaf_bounds: Optional[np.ndarray]   # [Q, n_leaves] (sorted parts only)


@dataclasses.dataclass
class ScanPlan:
    """Ordered scan schedule + the query summaries that priced it."""
    entries: List[ScanEntry]
    q_paas: np.ndarray             # [Q, w] float32
    nq: int

    @property
    def n_partitions(self) -> int:
        return len(self.entries)


def build_plan(partitions: Sequence[Partition], q_paas: np.ndarray, *,
               ts_min: Optional[int] = None,
               temporal_prune: bool = True,
               io=None) -> ScanPlan:
    """Plan the scan: filter by window, bound by fences, order by cost.

    Unsorted buffer partitions come first (they are the newest rows and
    have no fences to bound them), then sorted partitions cheapest fence
    bound first; ties keep the caller's order (newest first for LSM
    runs).  Empty partitions are dropped.
    """
    q_paas = np.atleast_2d(np.asarray(q_paas, np.float32))
    nq = q_paas.shape[0]
    with _span("plan", queries=nq) as sp:
        buffers: List[ScanEntry] = []
        sorted_entries: List[ScanEntry] = []
        dropped = 0
        for part in partitions:
            if part.n == 0:
                continue
            eff_ts = ts_min
            if ts_min is not None and part.ts_range is not None:
                t_lo, t_hi = part.ts_range
                if temporal_prune and t_hi < ts_min:
                    dropped += 1
                    continue           # wholly outside the window
                if t_lo >= ts_min:
                    eff_ts = None      # wholly inside: no row filter
            if not part.is_sorted:
                buffers.append(ScanEntry(part, eff_ts,
                                         np.zeros(nq, np.float32), None))
                continue
            env_lo, env_hi, part_env = _partition_envelopes(part, io=io)
            leaf_bounds = envelope_mindist_sq(q_paas, env_lo, env_hi,
                                              part.cfg)
            # the partition-level bound is the envelope of (first, last) key
            part_bound = envelope_mindist_sq(q_paas, *part_env,
                                             part.cfg)[:, 0]
            sorted_entries.append(ScanEntry(part, eff_ts, part_bound,
                                            leaf_bounds))
        order = np.argsort([e.part_bound.mean() for e in sorted_entries],
                           kind="stable")
        entries = buffers + [sorted_entries[i] for i in order]
        sp.set(partitions=len(entries), buffers=len(buffers),
               window_dropped=dropped)
    return ScanPlan(entries=entries, q_paas=q_paas, nq=nq)
