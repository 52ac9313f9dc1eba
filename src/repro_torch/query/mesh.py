"""MeshScanEngine: pinned shard columns on the scan mesh + one-launch scan.

The residency half of the device-resident sharded scan
(:mod:`repro_torch.kernels.mesh_scan` is the compute half).  The engine
owns:

* **Pinning** — stacking every shard's immutable run columns (SAX codes,
  raw series, global ids, timestamps) into ``[S, cap, ...]`` stacks padded
  to a bucket-rounded capacity, one ``[S/D, cap, ...]`` block per mesh
  device, so a probe batch launches with no host->device column traffic.
  The runs already live on the device, so the stacks are filled by
  device-to-device copies (a non-materialized run's rows are gathered
  from its ``raw_ref`` there).
* **Freshness** — a per-snapshot fingerprint ``(id(run.tree), rows,
  segment)`` per shard.  Runs are immutable once published, so any
  flush, merge, or rebalance yields a different run tuple and the next
  probe repins; the pinned state keeps strong references to the runs it
  mirrors, so an ``id()`` can never be recycled while it is part of a
  live fingerprint.
* **Invalidation hooks** — :meth:`on_invalidate` subscribes to
  ``TieredLeafStore`` invalidation (segment GC after flush / merge /
  rebalance) and drops the pinned stacks eagerly.  This frees device
  memory early; the fingerprint already forces the rebuild, so any
  invalidation clears everything.

What is NOT pinned: frozen insert buffers (unsorted, mutating every
insert) are scanned by the caller first, and their k-th distances seed
the launch ``bound``.

Distance bits: the launch selects each query's top-k rows, and
:meth:`MeshScanEngine.launch` re-verifies exactly those rows with the
gathered form of ``batch_euclid`` on the pinned stack — the routine every
ED of the port goes through — so the reported bits are the threaded
path's for the same rows.  Only the id -> slot lookup lives on the host.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import summarization as S
from ..kernels import ops
from ..launch.mesh import make_scan_mesh
from ..obs import get_registry, span as _span
from .planner import DeviceLayout, build_device_layout

__all__ = ["MeshScanEngine", "PinnedShards"]

_I32 = np.iinfo(np.int32)


@dataclasses.dataclass(frozen=True)
class PinnedShards:
    """One immutable pinned generation: the device mirror of one exact
    run-set.  Strong ``runs`` refs keep every mirrored tree alive so the
    fingerprint's ``id()`` components stay unambiguous.  Each stack is a
    tuple of per-device blocks in mesh order."""
    fingerprint: tuple
    layout: DeviceLayout
    mesh: Tuple[torch.device, ...]
    codes: Tuple[torch.Tensor, ...]   # [S/D, cap, w] uint8
    raw: Tuple[torch.Tensor, ...]     # [S/D, cap, L] float32
    ids: Tuple[torch.Tensor, ...]     # [S/D, cap] int32, -1 marks padding
    ts: Tuple[torch.Tensor, ...]      # [S/D, cap] int32 (zeros when absent)
    has_ts: bool                   # every pinned run carries timestamps
    rows: Tuple[int, ...]          # per-shard pinned row counts
    leaves: Tuple[int, ...]        # per-shard pinned leaf counts
    runs: tuple
    nbytes: int
    # the id -> flat-slot lookup on the host: the stacks' ids sorted, with
    # their flat slots (shard * cap + row) in the same order
    ids_sorted: np.ndarray
    id_order: np.ndarray

    @property
    def raw_flat(self) -> Tuple[torch.Tensor, ...]:
        """Each device's rows as one ``[S/D * cap, L]`` view."""
        return tuple(r.reshape(-1, r.shape[-1]) for r in self.raw)


class MeshScanEngine:
    """Thread-safe owner of the pinned device state for one sharded
    index.  ``pin`` returns the current generation (rebuilding if the
    snapshot moved), ``launch`` runs the mesh pass against it.

    The mesh spans the visible CUDA devices; an engine on the CPU
    (``device="cpu"``) spans that one device unless ``devices`` names
    others (a list of CPU entries stands in for a multi-device mesh).
    """

    def __init__(self, cfg: S.SummaryConfig, *, bucket: int = 2048,
                 max_pin_bytes: Optional[int] = None,
                 device=None, devices: Optional[Sequence] = None):
        self.cfg = cfg
        self.bucket = int(bucket)
        self.max_pin_bytes = max_pin_bytes
        if devices is None and device is not None \
                and torch.device(device).type == "cpu":
            devices = [torch.device("cpu")]
        self.devices = None if devices is None else list(devices)
        self._lock = threading.Lock()
        self._pinned: Optional[PinnedShards] = None
        self._reg = get_registry()
        # eager registration: operators see the full family at first
        # scrape, including the zero fallback count of a healthy server
        for c in ("query.mesh_launches_total",
                  "query.mesh_fallbacks_total",
                  "query.mesh_pins_total",
                  "query.mesh_invalidations_total"):
            self._reg.counter(c)

    # ------------------------------------------------------------ invalidation
    def on_invalidate(self, token=None) -> None:
        """``TieredLeafStore`` invalidation hook: a segment left the
        store, so the run set moved — drop every pinned stack now
        (frees device memory ahead of the fingerprint-forced repin)."""
        del token
        with self._lock:
            had = self._pinned is not None
            self._pinned = None
        if had:
            self._reg.counter("query.mesh_invalidations_total").inc()
            self._reg.gauge("query.mesh_pinned_bytes").set(0)

    def fallback(self, reason: str) -> None:
        """Record one probe batch taking the threaded seam instead."""
        self._reg.counter("query.mesh_fallbacks_total").inc()
        self._reg.counter(f"query.mesh_fallback.{reason}_total").inc()

    # ----------------------------------------------------------------- pinning
    @staticmethod
    def _fingerprint(snaps: Sequence) -> tuple:
        return tuple(tuple((id(r.tree), r.n, r.segment) for r in sn.runs)
                     for sn in snaps)

    def pin(self, snaps: Sequence) -> Optional[PinnedShards]:
        """The pinned generation mirroring ``snaps`` (one Snapshot per
        shard), rebuilding if any shard's run set changed.  Returns
        None when the snapshot cannot be pinned (ids missing or outside
        int32, or the pin budget would be exceeded) — the caller must
        fall back to the threaded path."""
        fp = self._fingerprint(snaps)
        with self._lock:
            cur = self._pinned
            if cur is not None and cur.fingerprint == fp:
                return cur
            # the old generation's stacks go before the new are filled
            self._pinned = None
            del cur
            pinned = self._build(snaps, fp)
            if pinned is not None:
                self._pinned = pinned
                self._reg.counter("query.mesh_pins_total").inc()
                self._reg.gauge("query.mesh_pinned_bytes").set(
                    pinned.nbytes)
            return pinned

    def _build(self, snaps: Sequence,
               fp: tuple) -> Optional[PinnedShards]:
        w, L = self.cfg.segments, self.cfg.series_len
        with _span("mesh_pin", shards=len(snaps)):
            runs, has_ts, rows, leaves = [], True, [], []
            for sn in snaps:
                for r in sn.runs:
                    t = r.tree
                    if t.ids is None:
                        return None
                    if t.n and (int(t.ids.min()) < 0
                                or int(t.ids.max()) > _I32.max):
                        return None
                    has_ts = has_ts and t.timestamps is not None
                    runs.append(r)
                rows.append(sum(r.n for r in sn.runs))
                leaves.append(sum(r.tree.n_leaves for r in sn.runs))
            mesh = make_scan_mesh(len(snaps), devices=self.devices)
            layout = build_device_layout(rows, n_devices=len(mesh),
                                         bucket=self.bucket)
            s, cap, spd = layout.n_shards, layout.cap, \
                layout.shards_per_device
            nbytes = s * cap * (w + 4 * L + 4 + 4)
            if self.max_pin_bytes is not None \
                    and nbytes > self.max_pin_bytes:
                return None
            codes, raw, ids, ts = [], [], [], []
            for j, dev in enumerate(mesh):
                c_j = torch.zeros((spd, cap, w), dtype=torch.uint8,
                                  device=dev)
                r_j = torch.zeros((spd, cap, L), dtype=torch.float32,
                                  device=dev)
                i_j = torch.full((spd, cap), -1, dtype=torch.int32,
                                 device=dev)
                t_j = torch.zeros((spd, cap), dtype=torch.int32, device=dev)
                for sl in range(spd):
                    at = 0
                    for r in snaps[j * spd + sl].runs:
                        t, n = r.tree, r.n
                        span_ = slice(at, at + n)
                        c_j[sl, span_] = t.codes
                        r_j[sl, span_] = (t.raw if t.raw is not None
                                          else t.raw_ref[t.offsets])
                        i_j[sl, span_] = t.ids
                        if t.timestamps is not None:
                            t_j[sl, span_] = t.timestamps
                        at += n
                codes.append(c_j)
                raw.append(r_j)
                ids.append(i_j)
                ts.append(t_j)
            # the id -> slot lookup: sorted on the device, kept on the host
            ids_all = torch.cat([i.reshape(-1).to(mesh[0]) for i in ids])
            ids_sorted, order = torch.sort(ids_all.long(), stable=True)
            return PinnedShards(
                fingerprint=fp, layout=layout, mesh=mesh,
                codes=tuple(codes), raw=tuple(raw), ids=tuple(ids),
                ts=tuple(ts), has_ts=has_ts, rows=tuple(rows),
                leaves=tuple(leaves), runs=tuple(runs), nbytes=nbytes,
                ids_sorted=ids_sorted.cpu().numpy(),
                id_order=order.cpu().numpy())

    # ---------------------------------------------------------------- launches
    def launch(self, pinned: PinnedShards, queries, q_paas,
               ts_min: Optional[np.ndarray], bound: np.ndarray, *, k: int):
        """One mesh pass over a pinned generation.

        ``ts_min`` is the per-shard ``[S]`` int32 visibility cut or None;
        ``bound`` the per-query strict bsf (inf = unbounded) from the
        buffer pool.  Returns host (dists [Q, k] f32, global ids [Q, k]
        int64 with -1 padding, counts [S, Q] int64).
        """
        home = pinned.mesh[0]
        q = torch.as_tensor(queries).to(home, torch.float32)
        q = q.reshape(-1, q.shape[-1])
        d, ids32, counts = ops.mesh_scan(
            q, torch.as_tensor(q_paas).to(home, torch.float32),
            pinned.codes, pinned.raw, pinned.ids, pinned.ts,
            None if ts_min is None
            else torch.as_tensor(ts_min).to(home, torch.int32),
            torch.as_tensor(bound).to(home, torch.float32), self.cfg, k=k)
        self._reg.counter("query.mesh_launches_total").inc()
        d = d.cpu().numpy().copy()
        ids64 = ids32.cpu().numpy().astype(np.int64)
        # canonical bits: the launch SELECTED these rows; their distances
        # are re-verified with the gathered ED on the pinned stack
        valid = ids64 >= 0
        if valid.any():
            slot = np.zeros_like(ids64)
            pos = np.searchsorted(pinned.ids_sorted, ids64[valid])
            slot[valid] = pinned.id_order[pos]
            per_dev = pinned.layout.shards_per_device * pinned.layout.cap
            for j, (dev, base) in enumerate(zip(pinned.mesh,
                                                pinned.raw_flat)):
                on_j = valid & (slot // per_dev == j)
                if not on_j.any():
                    continue
                idx = torch.from_numpy(np.where(on_j, slot % per_dev, 0))
                dj = ops.batch_euclid_multi(q.to(dev), base,
                                            idx=idx.to(dev))
                d[on_j] = dj.cpu().numpy()[on_j]
            # keep each query's pool sorted after the re-verification
            # (stable: sub-ulp rank flips keep the launch's order)
            sel = np.argsort(d, axis=1, kind="stable")
            d = np.take_along_axis(d, sel, axis=1)
            ids64 = np.take_along_axis(ids64, sel, axis=1)
        return d, ids64, counts.cpu().numpy().astype(np.int64)

    # ---------------------------------------------------------------- readouts
    @property
    def pinned(self) -> Optional[PinnedShards]:
        with self._lock:
            return self._pinned
