"""Range-partitioned Coconut-Tree across the scan mesh, and the
distributed SIMS exact search.

The paper names parallelization as future work (Sec. 7).  The reference
realizes it with ``shard_map`` over a device mesh; here the mesh is the
port's ordered tuple of ``torch.device`` (:mod:`repro_torch.launch.mesh`),
one shard per entry, and each step runs shard by shard:

* **bulk-load**: each shard's block of rows is summarized by the
  ``fused_build`` kernel on its device, then the sample-sort
  (:mod:`repro_torch.distributed.samplesort`) range-partitions the z-order
  keyspace; each shard IS a local Coconut-Tree over its contiguous key
  range, and the shards laid end to end are the single-device sort.
  Raw rows, PAA, codes and the optional timestamps (float32, as the
  reference's payload carries them) travel with the keys.  Each shard is
  stored unpadded (the reference pads to ``d * cap`` rows).
* **query**: the query batch goes to every shard; each shard keeps its
  own ``[Q, k]`` candidates, and the ``d`` lists are gathered to the first
  device and merged by a stable selection, ties to the lowest (shard,
  slot) as the reference's ``top_k`` over the gathered lists gives them.
  Without a budget a shard is one ``scan_verify`` launch with bound +inf
  (every row live: the mesh scan's per-device body); with a budget it is
  one ``mindist_batch`` launch, the ``budget`` best bounds per query by a
  stable sort, and the gathered ``batch_euclid`` form over those rows.
  The final distances are the gathered ``batch_euclid`` form's (the
  routine every ED of the port goes through), so the answers carry the
  single-device tree's bits.

Rows returned for inf-distance slots (fewer than ``k`` rows in the
window) are zeros; the reference leaves them unspecified.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import summarization as S
from ..core.tree import _as
from ..kernels import ops
from ..kernels.mesh_scan import _device_body
from ..launch.mesh import make_scan_mesh
from .samplesort import sort_blocks

__all__ = ["ShardedCoconutTree", "build_sharded", "distributed_exact_search",
           "distributed_exact_search_batch", "sharded_tree_from_arrays"]

OVERFLOW = "sample-sort bucket overflow; raise cap_factor"


@dataclasses.dataclass
class ShardedCoconutTree:
    """Sorted index split by key range: shard ``j`` owns range ``j`` and
    its columns lie on ``mesh[j]``, unpadded."""
    keys: List[torch.Tensor]     # [n_j, n_words] int64 words, z-order sorted
    codes: List[torch.Tensor]    # [n_j, w] uint8
    paas: List[torch.Tensor]     # [n_j, w] float32
    raw: List[torch.Tensor]      # [n_j, L] float32 (co-sorted with keys)
    counts: torch.Tensor         # [d] int32 as the sample-sort reported them
    cfg: S.SummaryConfig
    mesh: Tuple[torch.device, ...]
    ts: Optional[List[torch.Tensor]] = None   # [n_j] float32 timestamps

    @property
    def n_valid(self) -> int:
        return int(self.counts.abs().sum())


def _default_mesh(n_shards: Optional[int]) -> Tuple[torch.device, ...]:
    """One entry per shard over :func:`make_scan_mesh`'s devices (each
    device holds a contiguous run of shards); one shard per visible card
    when ``n_shards`` is None.  Raises without a CUDA device."""
    if n_shards is None:
        n_shards = max(torch.cuda.device_count(), 1)
    devs = make_scan_mesh(n_shards)
    per = n_shards // len(devs)
    return tuple(devs[j // per] for j in range(n_shards))


def build_sharded(mesh, raw, cfg: S.SummaryConfig, *,
                  cap_factor: float = 2.0,
                  timestamps=None) -> ShardedCoconutTree:
    """Distributed bulk-load: summarize each shard's block on its device
    (``fused_build``), then sample-sort globally.

    ``mesh``: the scan mesh (a sequence of devices, one shard each), or
    None for one shard per visible card.  ``raw``: ``[N, L]`` with N
    divisible by the shard count; shard ``i`` starts with rows
    ``i*N/d .. (i+1)*N/d - 1``.  ``timestamps`` (optional ``[N]``) are
    carried as float32, so window queries (``ts_min``) are exact for
    values below 2**24, as in the reference.
    """
    mesh = _default_mesh(None) if mesh is None else \
        tuple(torch.device(m) for m in mesh)
    if not isinstance(raw, torch.Tensor):
        raw = _as(raw, torch.float32, "cpu")
    d = len(mesh)
    n = raw.shape[0]
    if n % d:
        raise ValueError(f"N={n} must divide over {d} shards")
    nl = n // d
    ts = None if timestamps is None else \
        _as(timestamps, torch.float32, raw.device)
    key_blocks, col_blocks = [], []
    for i, dev in enumerate(mesh):
        blk = _as(raw[i * nl:(i + 1) * nl], torch.float32, dev)
        paas, codes, keys = ops.summarize_and_key(blk, cfg)
        cols = [blk, paas, codes]
        if ts is not None:
            cols.append(ts[i * nl:(i + 1) * nl].to(dev))
        key_blocks.append(keys)
        col_blocks.append(cols)
    skeys, scols, counts = sort_blocks(mesh, key_blocks, col_blocks,
                                       cap_factor=cap_factor)
    if bool((counts < 0).any()):
        raise RuntimeError(OVERFLOW)
    return ShardedCoconutTree(
        keys=skeys, raw=[c[0] for c in scols], paas=[c[1] for c in scols],
        codes=[c[2] for c in scols],
        ts=None if ts is None else [c[3] for c in scols],
        counts=counts, cfg=cfg, mesh=mesh)


def sharded_tree_from_arrays(keys, codes, paas, raw, counts,
                             cfg: S.SummaryConfig, mesh=None, *,
                             ts=None) -> ShardedCoconutTree:
    """The port's tree from the reference's padded arrays: ``keys``
    ``[d*M, n_words]`` uint32 words, ``codes``/``paas``/``raw`` (and
    ``ts``) with the same ``d*M`` rows, shard ``j`` in rows ``j*M ..``;
    each shard is cut to its valid count (``c``, or ``-c - 1`` for an
    overflow's negative count) and moved to ``mesh[j]`` (default: one
    entry per shard over :func:`make_scan_mesh`'s devices)."""
    counts = torch.as_tensor(np.asarray(counts, np.int32))
    d = counts.shape[0]
    mesh = _default_mesh(d) if mesh is None else \
        tuple(torch.device(m) for m in mesh)
    if len(mesh) != d:
        raise ValueError(f"{d} shards on a mesh of {len(mesh)}")
    m = np.asarray(keys).shape[0] // d
    valid = [int(c) if c >= 0 else -int(c) - 1 for c in counts]

    def cut(a, dtype):
        a = np.asarray(a)
        return [torch.as_tensor(a[j * m:j * m + valid[j]].astype(dtype))
                .to(mesh[j]) for j in range(d)]

    return ShardedCoconutTree(
        keys=cut(keys, np.int64), codes=cut(codes, np.uint8),
        paas=cut(paas, np.float32), raw=cut(raw, np.float32),
        ts=None if ts is None else cut(ts, np.float32),
        counts=counts, cfg=cfg, mesh=mesh)


def _full_verify(q, q_paas, tree, j, cut, k):
    """Every row of shard ``j`` (not cut by the window) verified: one
    ``scan_verify`` launch with bound +inf on a card, its twin on the CPU.
    Returns (dists ``[Q, k]``, local rows ``[Q, k]`` with -1 padding)."""
    dev = tree.mesh[j]
    n = tree.raw[j].shape[0]
    lower, upper, _ = ops._tables(tree.cfg.bits, dev)
    ts = tree.ts[j][None] if cut is not None else None
    d, rows, _ = _device_body(
        q, q_paas, tree.codes[j][None], tree.raw[j][None],
        torch.arange(n, dtype=torch.int32, device=dev)[None], ts,
        None if cut is None else cut.reshape(1),
        torch.full((q.shape[0],), float("inf"), device=dev), lower, upper,
        scale=tree.cfg.series_len / tree.cfg.segments, k=k)
    return d, rows


def _budget_verify(q, q_paas, tree, j, cut, k, budget):
    """The ``budget`` rows of shard ``j`` with the smallest bounds per
    query (a stable sort: ties to the lowest row; a shard with fewer rows
    is padded with +inf bounds), verified.  Returns (dists ``[Q, k]``,
    local rows ``[Q, k]``, certified ``[Q]``)."""
    n = tree.raw[j].shape[0]
    md = ops.mindist_batch(q_paas, tree.codes[j], tree.cfg)       # [Q, n]
    if cut is not None:
        md = md.masked_fill((tree.ts[j] < cut)[None, :], float("inf"))
    if n < budget:
        md = torch.nn.functional.pad(md, (0, budget - n), value=float("inf"))
    vals, order = torch.sort(md, dim=1, stable=True)
    del md
    vals, order = vals[:, :budget], order[:, :budget].clamp_max(n - 1)
    ed = ops.batch_euclid_multi(q, tree.raw[j], idx=order)        # [Q, B]
    ed = torch.where(torch.isfinite(vals), ed, torch.full_like(ed, np.inf))
    sd, si = torch.sort(ed, dim=1, stable=True)
    d, rows = sd[:, :k].contiguous(), torch.gather(order, 1, si[:, :k])
    return d, rows, vals[:, budget - 1] >= d[:, 0]


def distributed_exact_search_batch(tree: ShardedCoconutTree, queries,
                                   k: int = 1, *,
                                   budget: Optional[int] = None,
                                   ts_min: Optional[int] = None):
    """Batched exact k-NN over every shard, one ``[Q, k]`` list a shard,
    merged on the first device.

    queries ``[Q, L]`` -> (dists_sq ``[Q, k]``, rows ``[Q, k, L]``), on
    ``tree.mesh[0]``.  Row qi with k=1 equals
    ``distributed_exact_search(tree, queries[qi])``.

    ``ts_min``: restrict to rows with timestamp >= float32(ts_min)
    (requires ``build_sharded(..., timestamps=...)``).
    ``budget``: verify only the ``budget`` best lower bounds per shard;
    the return grows a third element ``certified [Q]`` — True iff on
    every shard the ``budget``-th bound reaches that shard's best
    distance, so the answer is provably exact.
    """
    if ts_min is not None and tree.ts is None:
        raise ValueError("ts_min needs a tree built with timestamps")
    if budget is not None and not k <= budget:
        raise ValueError(f"budget={budget} must be at least k={k}")
    home = tree.mesh[0]
    q_all = _as(queries, torch.float32, home)
    q_all = q_all[None, :] if q_all.ndim == 1 else q_all
    nq, L = q_all.shape
    cut = None if ts_min is None else torch.tensor(np.float32(ts_min))
    ds, rows, cert = [], [], torch.ones(nq, dtype=torch.bool, device=home)
    for j, dev in enumerate(tree.mesh):
        if tree.raw[j].shape[0] == 0:
            continue
        q = q_all.to(dev)
        q_paas = S.paa(q, tree.cfg.segments)
        c = None if cut is None else cut.to(dev)
        if budget is None:
            d, r = _full_verify(q, q_paas, tree, j, c, k)
            # the final bits: the gathered ED of the selected rows
            sel = r.clamp_min(0).long()
            d = torch.where(torch.isfinite(d),
                            ops.batch_euclid_multi(q, tree.raw[j], idx=sel),
                            d)
        else:
            d, sel, ok = _budget_verify(q, q_paas, tree, j, c, k, budget)
            cert &= ok.to(home)
        ds.append(d.to(home))
        rows.append(tree.raw[j][sel].to(home))
    if ds:
        sd, si = torch.sort(torch.cat(ds, dim=1), dim=1, stable=True)
        out_d = sd[:, :k].contiguous()
        out_r = torch.gather(torch.cat(rows, dim=1), 1,
                             si[:, :k, None].expand(nq, -1, L))
    else:                         # every shard empty
        out_d = torch.full((nq, k), float("inf"), device=home)
        out_r = torch.zeros((nq, k, L), device=home)
    out_r = torch.where(torch.isfinite(out_d)[..., None], out_r,
                        torch.zeros_like(out_r))
    if budget is None:
        return out_d, out_r
    return out_d, out_r, cert


def distributed_exact_search(tree: ShardedCoconutTree, query, k: int = 1, *,
                             ts_min: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN for one query — Q=1 wrapper over
    :func:`distributed_exact_search_batch` (one body).

    Returns (dists_sq ``[k]``, rows ``[k, L]``) — the k nearest raw series.
    """
    q = _as(query, torch.float32, tree.mesh[0]).reshape(1, -1)
    d, rows = distributed_exact_search_batch(tree, q, k, ts_min=ts_min)
    return d[0], rows[0]
