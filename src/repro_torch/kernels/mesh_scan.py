"""The one-launch device-resident sharded scan over the scan mesh.

The threaded sharded path fans a probe batch out to one pipeline per shard
and merges their pools on the host.  This module scans every shard's
pinned columns in one pass instead: the ``[S, cap, ...]`` stacks are split
over the mesh's D devices (``S / D`` contiguous sub-shards each, see
:mod:`repro_torch.launch.mesh`), each device scans its sub-shards, and the
per-device ``[Q, k]`` lists are gathered to the first device, which
selects.  It replaces the reference's ``shard_map`` program
(``kernels/mesh_scan.py``), which calls no TPU kernel of its own: its
per-device body is ``scan_verify`` or a plain composition.

The per-device body on a CUDA device is the ``scan_verify`` kernel, one
launch per sub-shard over its contiguous ``[cap]`` slice, every launch
with the same bound (the caller's per-query best-so-far), so the live
counts are the plain body's.  The sub-shards' lists are merged by
selection only — a stable sort over the shard-ordered concatenation, so
ties go to the lowest (shard, row) as in a top-k over the flat stack.
On the CPU the body is the plain twin :func:`local_scan_topk` over the
device's flattened sub-shards; it is the oracle, never the card's path.
Distance values flow through the merge unchanged.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .ref import local_scan_topk
from .scan_verify import scan_verify

__all__ = ["local_scan_topk", "mesh_scan_launch"]


def _select(d: torch.Tensor, ids: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of ``[Q, M]`` candidate lists, ties to the earlier
    column, with -1 ids where the distance is inf."""
    sd, sel = torch.sort(d, dim=1, stable=True)
    out_d = sd[:, :k].contiguous()
    out_i = torch.gather(ids, 1, sel[:, :k])
    out_i = torch.where(torch.isfinite(out_d), out_i,
                        torch.full_like(out_i, -1))
    return out_d, out_i


def _device_body(queries, q_paas, codes, raw, ids, ts, ts_min, bound,
                 lower, upper, *, scale: float, k: int):
    """One device's sub-shards ``[spd, cap, ...]`` -> (dists ``[Q, k]``,
    global ids ``[Q, k]`` int32, counts ``[spd, Q]`` int32)."""
    spd, cap = ids.shape
    nq = queries.shape[0]
    dead = ids < 0
    if ts_min is not None:
        dead = dead | (ts < ts_min[:, None])
    ids_f = ids.reshape(spd * cap)
    if codes.device.type == "cpu":
        d, idx, live = local_scan_topk(
            queries, q_paas, codes.reshape(spd * cap, codes.shape[-1]),
            raw.reshape(spd * cap, raw.shape[-1]), dead.reshape(spd * cap),
            bound, lower, upper, scale=scale, k=k)
        counts = live.reshape(nq, spd, cap).sum(dim=2).T.to(torch.int32)
        out = torch.where(idx >= 0, ids_f[idx.clamp_min(0).long()],
                          torch.full_like(idx, -1))
        return d, out, counts.contiguous()
    ds, rows, counts = [], [], []
    for s in range(spd):
        d_s, i_s, c_s, _ = scan_verify(queries, q_paas, codes[s], raw[s],
                                       lower, upper, bound, dead[s],
                                       scale=scale, k=k)
        ds.append(d_s)
        rows.append(torch.where(i_s >= 0, i_s.long() + s * cap,
                                torch.zeros_like(i_s, dtype=torch.long)))
        counts.append(c_s)
    flat = torch.cat(rows, dim=1)
    d, out = _select(torch.cat(ds, dim=1), ids_f[flat], k)
    return d, out, torch.stack(counts)


def mesh_scan_launch(queries: torch.Tensor, q_paas: torch.Tensor,
                     codes: Sequence[torch.Tensor],
                     raw: Sequence[torch.Tensor],
                     ids: Sequence[torch.Tensor],
                     ts: Sequence[torch.Tensor],
                     ts_min: Optional[torch.Tensor], bound: torch.Tensor,
                     tables: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
                     scale: float, k: int):
    """The whole-batch launch over the mesh.

    ``codes`` / ``raw`` / ``ids`` / ``ts`` hold one block per mesh device,
    in mesh order: ``[spd, cap, w]`` uint8, ``[spd, cap, L]`` f32,
    ``[spd, cap]`` int32 (-1 marks padding) and ``[spd, cap]`` int32, each
    on its device; ``tables`` the (lower, upper) region tables on each.
    ``queries`` ``[Q, L]``, ``q_paas`` ``[Q, w]`` and ``bound`` ``[Q]`` (the
    strict per-query best-so-far) sit on the first device; ``ts_min`` is
    the per-shard ``[S]`` int32 visibility cut, or None for no window.
    Returns (dists ``[Q, k]``, global ids ``[Q, k]`` int32 with -1
    padding, counts ``[S, Q]`` int32), on the first device.
    """
    home = codes[0].device
    ds, outs, counts = [], [], []
    at = 0
    for c, r, i, t, (lo, hi) in zip(codes, raw, ids, ts, tables):
        dev, spd = c.device, i.shape[0]
        tm = None if ts_min is None else ts_min[at:at + spd].to(dev)
        d, o, n = _device_body(queries.to(dev), q_paas.to(dev), c, r, i, t,
                               tm, bound.to(dev), lo, hi, scale=scale, k=k)
        ds.append(d.to(home))
        outs.append(o.to(home))
        counts.append(n.to(home))
        at += spd
    d, out = _select(torch.cat(ds, dim=1), torch.cat(outs, dim=1), k)
    return d, out, torch.cat(counts)
