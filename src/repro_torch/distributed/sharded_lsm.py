"""ShardedCoconutLSM: the key-range-partitioned, multi-shard serving layer.

This unifies the repo's two scale mechanisms — the static sharded
Coconut-Tree (``sharded_index.py``) and the streaming Coconut-LSM
(``core/lsm.py`` + ``ingest/``) — into one engine: N full ``CoconutLSM``
shards partitioned by z-order key range, behind a router that

  * **routes inserts** by interleaved key (boundaries estimated with the
    sample-sort splitter rule, re-estimated online from a key reservoir),
    assigning every row a *global* id and a timestamp from one shared
    clock, so answers are bit-identical for any shard count;
  * **fans out searches** cheapest-shard-first: per-shard fence mindist
    bounds (from the shards' run/buffer key fences) order the visit, the
    best-so-far pool from the most promising shard seeds
    ``search_exact_batch(..., bsf=)`` on the rest, and shards whose
    bound cannot beat the chain are skipped whole (``shards_pruned``);
  * **bounds ingest** with a shared backpressure budget: per-shard WALs
    and compactors run independently, but ``insert`` blocks once the
    *total* outstanding compaction debt exceeds ``max_debt``;
  * **persists** every shard under one data dir (``ShardDirectory``):
    per-shard manifests + WALs for row durability, one atomic top-level
    ``SHARDS.json`` for the shard count and routing boundaries, so a
    crash anywhere — including between per-shard manifest commits —
    reopens consistently with no acked row lost;
  * **rebalances** under skew: sampled keys re-estimate the splitters,
    and a split/merge migration rebuilds the shard set (new generation
    of shard dirs, atomically committed) with ids/timestamps preserved,
    so answers are unchanged by the move.

Exactness composes across shards for the same reason it composes across
runs and the frozen buffer (see ``ingest/snapshot.py``): exact distances
are verified with one kernel routine whose lane order fixes the bits of
a (query, row) pair, so partitioning — temporal or by key range — never
changes the bits.

Every shard is a :class:`CoconutLSM` on the engine's device — the card
unless the engine is made with ``device="cpu"``.  An insert batch is
summarized once on that device (``sax_summarize``, then ``zorder``) and
only its keys come back to the host to route it.  An insert's
sub-batches go to their shards on a thread pool (so their WAL fsyncs
overlap); those threads, the searches and concurrent shards' compactors
all launch on the device's default stream, so the kernels' per-stream
workspaces are used in launch order.

Visibility contract (matching ``CoconutLSM``): **concurrent** engines
answer over every acked row at any instant (buffer-inclusive snapshots),
so answers are shard-count-invariant at every interleaving point.
**Synchronous** engines reproduce the synchronous-LSM contract — rows
buffered and not yet flushed are invisible — and since each shard's
buffer fills at its own rate, the *visible* row set mid-stream depends
on the partition; invariance for synchronous engines therefore holds
after ``flush()`` (when everything is visible), not mid-buffer.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import summarization as S
from ..core import tree as T
from ..core.lsm import CoconutLSM
from ..core.metrics import IngestMetrics, IOStats
from ..obs import get_registry, probe, span as _span
from ..query.executor import _queries_np
from ..query.merger import SearchStats, merge_pools
from .router import (KeyRangeRouter, batch_summaries, fence_mindist_sq,
                     key_fence_of, key_range_code_bounds)

__all__ = ["ShardedCoconutLSM"]


class _AggregateIngest:
    """Read-only merge of the per-shard ``IngestMetrics`` plus the
    router's own counters (counters sum, gauges sum — lag/debt gauges
    are extensive quantities here)."""

    def __init__(self, owner: "ShardedCoconutLSM"):
        self._owner = owner

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self._owner.metrics.snapshot())
        for s in self._owner._shard_list():
            for k, v in s.ingest.snapshot().items():
                out[k] = out.get(k, 0) + v
        return out

    def get(self, name: str) -> float:
        return (self._owner.metrics.get(name)
                + sum(s.ingest.get(name)
                      for s in self._owner._shard_list()))


class ShardedCoconutLSM:
    """Router + N ``CoconutLSM`` shards partitioned by z-order key range."""

    def __init__(self, cfg: S.SummaryConfig, *,
                 shards: int = 2,
                 boundaries: Optional[np.ndarray] = None,
                 buffer_capacity: int = 4096,
                 leaf_size: int = 256,
                 size_ratio: int = 2,
                 mode: str = "btp",
                 materialized: bool = True,
                 io: Optional[IOStats] = None,
                 data_dir: Optional[str] = None,
                 concurrent: bool = False,
                 wal_fsync: str = "always",
                 max_debt: int = 4,
                 sample_cap: int = 8192,
                 rebalance_every: int = 0,
                 rebalance_factor: float = 1.5,
                 tiers=None,
                 scan_mode: str = "threaded",
                 device=None):
        """``max_debt`` is the SHARED budget: total outstanding
        flush/merge units across all shards (each shard also keeps it as
        its local cap, which can only be tighter).  ``rebalance_every``
        > 0 checks skew (and possibly migrates) every that-many inserted
        rows; 0 leaves rebalancing to explicit :meth:`rebalance` calls.
        ``data_dir`` makes the engine durable via a ``ShardDirectory``;
        reopen an existing one with :meth:`open`.  ``scan_mode`` picks
        the default probe policy: ``"threaded"`` (per-shard pipelines)
        or ``"mesh"`` (one device-resident launch over every shard, falling
        back to threaded whenever the batch cannot run on device).  Every
        shard lives on ``device`` (the card unless ``device="cpu"``)."""
        if shards < 1:
            raise ValueError("shards must be >= 1")
        device = T._device_for(None, device)
        shard_dir = None
        stores: List = [None] * shards
        dirs: List[str] = []
        if data_dir is not None:
            from ..storage.store import ShardDirectory
            shard_dir = ShardDirectory(data_dir, io=io)
            if shard_dir.exists():
                raise ValueError(
                    f"{data_dir} already holds a committed sharded index "
                    "— reopen it with ShardedCoconutLSM.open instead")
            dirs = [shard_dir.shard_dir_name(i, 0) for i in range(shards)]
            stores = [shard_dir.shard_store(d) for d in dirs]
        # ONE TieredLeafStore shared by every shard: cache keys are
        # segment paths (unique across shard dirs), so shards share the
        # byte budget without colliding
        engines = [CoconutLSM(cfg, buffer_capacity=buffer_capacity,
                              leaf_size=leaf_size, size_ratio=size_ratio,
                              mode=mode, materialized=materialized,
                              io=io, store=stores[i],
                              concurrent=concurrent,
                              wal_fsync=wal_fsync, max_debt=max_debt,
                              tiers=tiers, device=device)
                   for i in range(shards)]
        router = KeyRangeRouter(cfg, shards, boundaries=boundaries,
                                sample_cap=sample_cap)
        self._finish_init(cfg, engines, router, shard_dir, dirs,
                          generation=0, clock=0, next_id=0,
                          buffer_capacity=buffer_capacity,
                          leaf_size=leaf_size, size_ratio=size_ratio,
                          mode=mode, materialized=materialized, io=io,
                          concurrent=concurrent, wal_fsync=wal_fsync,
                          max_debt=max_debt,
                          rebalance_every=rebalance_every,
                          rebalance_factor=rebalance_factor,
                          tiers=tiers, scan_mode=scan_mode, device=device)
        if shard_dir is not None:
            self._commit_meta()   # reopenable from birth, like CoconutLSM

    def _finish_init(self, cfg, engines, router, shard_dir, dirs, *,
                     generation, clock, next_id, buffer_capacity,
                     leaf_size, size_ratio, mode, materialized, io,
                     concurrent, wal_fsync, max_debt, rebalance_every,
                     rebalance_factor, tiers=None,
                     scan_mode: str = "threaded", device=None) -> None:
        if scan_mode not in ("threaded", "mesh"):
            raise ValueError(
                f"scan_mode must be 'threaded' or 'mesh', "
                f"got {scan_mode!r}")
        self.cfg = cfg
        self.device = device
        self.tiers = tiers if shard_dir is not None else None
        self.scan_mode = scan_mode
        # device-resident scan engine, built lazily on the first mesh probe
        self._mesh_engine = None
        self._mesh_engine_lock = threading.Lock()
        self.n_shards = len(engines)
        self.mode = mode
        self.buffer_capacity = buffer_capacity
        self.leaf_size = leaf_size
        self.size_ratio = size_ratio
        self.materialized = materialized
        self.io = io
        self.concurrent = concurrent
        self.wal_fsync = wal_fsync
        self.max_debt = max_debt
        self.rebalance_every = rebalance_every
        self.rebalance_factor = rebalance_factor
        self.router = router
        self.clock = clock
        self._next_id = next_id
        self._shards = list(engines)
        self._shard_dir = shard_dir
        self._dirs = list(dirs)
        self._generation = generation
        self._closed = False
        self._mutex = threading.Lock()        # ingest / migration order
        self._state_lock = threading.Lock()   # shard list + clock + ids
        self._debt_cv = threading.Condition() # shared backpressure budget
        # odd while a routed batch is mid-flight across shards; searches
        # use it to capture an atomic multi-shard snapshot set
        self._epoch = 0
        self._since_rebalance = 0
        self.metrics = IngestMetrics()        # router-level counters
        self.ingest = _AggregateIngest(self)
        # fan-out pool: per-shard sub-batch inserts are independent
        # (disjoint rows, separate WALs/locks), so their WAL fsyncs run
        # in parallel instead of serializing the ack behind n_shards
        # sequential syncs
        self._pool = (ThreadPoolExecutor(
            max_workers=self.n_shards,
            thread_name_prefix="coconut-router")
            if self.n_shards > 1 else None)
        for s in self._shards:
            s.debt_cv = self._debt_cv

    # ------------------------------------------------------------ persistence
    @classmethod
    def open(cls, data_dir: str, *,
             io: Optional[IOStats] = None,
             concurrent: bool = False,
             wal_fsync: str = "always",
             max_debt: int = 4,
             sample_cap: int = 8192,
             rebalance_every: int = 0,
             rebalance_factor: float = 1.5,
             tiers=None,
             scan_mode: str = "threaded",
             device=None) -> "ShardedCoconutLSM":
        """Reopen a persisted sharded index.

        Cleans up migration orphans, reopens every shard from its own
        manifest (each replays its WAL tail, restoring the global ids
        and timestamps the rows were acked with), and restores the
        router boundaries from the atomic top-level manifest — so the
        reopened engine answers exactly like the one that crashed, for
        every crash point including between per-shard manifest commits.
        The shards' runs go to ``device`` (the card unless
        ``device="cpu"``).
        """
        from ..storage.store import ShardDirectory
        device = T._device_for(None, device)
        shard_dir = ShardDirectory(data_dir, io=io)
        meta = shard_dir.load()
        if meta is None:
            raise FileNotFoundError(
                f"no committed {shard_dir.meta_path}")
        shard_dir.cleanup()
        cfg = S.SummaryConfig(**meta["cfg"])
        p = meta["params"]
        engines = [CoconutLSM.open(shard_dir.shard_store(d), io=io,
                                   concurrent=concurrent,
                                   wal_fsync=wal_fsync, max_debt=max_debt,
                                   tiers=tiers, device=device)
                   for d in meta["dirs"]]
        router = KeyRangeRouter(
            cfg, len(engines),
            boundaries=KeyRangeRouter.boundaries_from_json(
                meta["boundaries"]),
            sample_cap=sample_cap)
        clock = max((e.clock for e in engines), default=0)
        # surviving ids need not be a dense prefix after a crash mid
        # routed batch — restart the allocator above the global max
        next_id = max((e.max_id() for e in engines), default=-1) + 1
        obj = cls.__new__(cls)
        obj._finish_init(cfg, engines, router, shard_dir, meta["dirs"],
                         generation=meta["generation"], clock=clock,
                         next_id=next_id,
                         buffer_capacity=p["buffer_capacity"],
                         leaf_size=p["leaf_size"],
                         size_ratio=p["size_ratio"], mode=p["mode"],
                         materialized=p["materialized"], io=io,
                         concurrent=concurrent, wal_fsync=wal_fsync,
                         max_debt=max_debt,
                         rebalance_every=rebalance_every,
                         rebalance_factor=rebalance_factor,
                         tiers=tiers, scan_mode=scan_mode, device=device)
        for e in engines:
            e.advance_clock(clock)
        return obj

    def _commit_meta(self) -> None:
        """Atomically publish shard count + boundaries + live dirs."""
        if self._shard_dir is None:
            return
        self._shard_dir.commit({
            "n_shards": self.n_shards,
            "boundaries": self.router.boundaries_json(),
            "dirs": self._dirs,
            "generation": self._generation,
            "cfg": {"series_len": self.cfg.series_len,
                    "segments": self.cfg.segments,
                    "bits": self.cfg.bits},
            "params": {"buffer_capacity": self.buffer_capacity,
                       "leaf_size": self.leaf_size,
                       "size_ratio": self.size_ratio,
                       "mode": self.mode,
                       "materialized": self.materialized},
        })

    # ------------------------------------------------------------------ write
    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("ShardedCoconutLSM is closed")

    def _shard_list(self) -> List[CoconutLSM]:
        with self._state_lock:
            return list(self._shards)

    def insert(self, raw: np.ndarray,
               timestamps: Optional[np.ndarray] = None) -> None:
        """Route one insert batch ``[n, L]`` (host rows; a tensor is
        copied to the host) to its key-range shards.

        Each row gets a global id (insert-stream position across ALL
        shards) and a timestamp from the shared clock; both ride the
        per-shard WAL, so crash replay restores them.  On return every
        row is acked by its shard (WAL-durable with a data dir).  Blocks
        when total compaction debt across shards exceeds ``max_debt``.
        """
        self._check_open()
        if isinstance(raw, torch.Tensor):
            raw = raw.detach().cpu().numpy()
        raw = np.asarray(raw, np.float32)
        n = raw.shape[0]
        if n == 0:
            return
        with self._mutex:
            with self._state_lock:
                if timestamps is None:
                    timestamps = np.arange(self.clock, self.clock + n,
                                           dtype=np.int64)
                else:
                    timestamps = np.asarray(timestamps, np.int64)
                # monotone, matching CoconutLSM.insert bit for bit
                self.clock = max(self.clock, int(timestamps.max()) + 1)
                clock = self.clock
                ids = np.arange(self._next_id, self._next_id + n,
                                dtype=np.int64)
                self._next_id += n
                shards = list(self._shards)
            # summarize ONCE: the same PAA/SAX drives routing here and the
            # run build at flush time (threaded through insert summaries=)
            keys, paas, codes = batch_summaries(raw, self.cfg, self.device)
            if self.router.ensure_boundaries(keys):
                self._commit_meta()   # boundaries durable BEFORE any ack
            self.router.observe(keys)
            dest = self.router.route(keys)
            with self._state_lock:
                self._epoch += 1      # odd: routed batch in flight
            try:
                reg = get_registry()

                def put(si: int, m: np.ndarray) -> None:
                    rows = torch.from_numpy(np.nonzero(m)[0]).to(
                        paas.device)
                    shards[si].insert(raw[m], timestamps[m], ids=ids[m],
                                      key_fence=key_fence_of(keys[m]),
                                      summaries=(paas[rows], codes[rows]))
                    # per-shard load counters: the skew signal the
                    # workload analyzer / rebalance trigger read
                    reg.counter(f"shard.s{si}.rows_total").inc(
                        int(m.sum()))
                    reg.gauge(f"shard.s{si}.size_rows").set(
                        shards[si].n)

                masks = [(si, dest == si) for si in range(self.n_shards)]
                masks = [(si, m) for si, m in masks if m.any()]
                if self._pool is not None and len(masks) > 1:
                    # parallel fan-out: the ack (and its WAL fsyncs)
                    # costs one shard's latency, not the sum
                    futs = [self._pool.submit(put, si, m)
                            for si, m in masks]
                    for f in futs:
                        f.result()
                else:
                    for si, m in masks:
                        put(si, m)
                for s in shards:
                    s.advance_clock(clock)
            finally:
                with self._state_lock:
                    self._epoch += 1  # even: every shard acked
            self._since_rebalance += n
        self._wait_budget()
        if (self.rebalance_every
                and self._since_rebalance >= self.rebalance_every):
            self._since_rebalance = 0
            self.rebalance()

    def _wait_budget(self) -> None:
        """Shared backpressure: block while the TOTAL compaction debt
        across shards exceeds the budget.  Compactors poke ``_debt_cv``
        after every retired unit (see ``Compactor._notify_external``)."""
        if not self.concurrent:
            return
        throttled = False
        while True:
            shards = self._shard_list()
            for s in shards:
                if s._compactor is not None:
                    s._compactor.check()
            alive = all(s._compactor is None or s._compactor.alive
                        for s in shards)
            total = sum(s.compaction_debt() for s in shards)
            if total <= self.max_debt or not alive:
                return
            if not throttled:
                self.metrics.add("backpressure_waits")
                throttled = True
            with self._debt_cv:
                self._debt_cv.wait(timeout=0.2)

    def flush(self) -> None:
        """Flush + settle every shard (drains compactors when concurrent)."""
        self._check_open()
        with self._mutex:
            for s in self._shard_list():
                s.flush()

    def checkpoint(self) -> None:
        """Request durable manifest commits on every shard (non-blocking
        for concurrent shards, inline flush+commit otherwise).  Holds the
        ingest mutex so a racing migration cannot close the captured
        shards mid-iteration (per-shard checkpoint itself is cheap)."""
        self._check_open()
        with self._mutex:
            for s in self._shard_list():
                s.checkpoint()

    # -------------------------------------------------------------- rebalance
    def rebalance(self, *, force: bool = False) -> bool:
        """Re-estimate boundaries from the key reservoir and migrate if
        the observed density is skewed (or ``force``).

        The migration drains every shard, extracts all rows (raw,
        timestamps, global ids), rebuilds a fresh shard set under the new
        boundaries (a new generation of shard dirs when durable), commits
        the top-level manifest atomically, then retires the old shards.
        Ids and timestamps move with the rows, so answers are unchanged;
        with concurrent shards the rebuilt runs are produced by the new
        shards' compactors (migration work is compaction debt).
        Returns True when a migration happened.
        """
        self._check_open()
        if self.n_shards == 1:
            return False
        with self._mutex:
            new_b = self.router.reestimate()
            if new_b is None:
                return False
            if self.router.boundaries is not None \
                    and np.array_equal(new_b, self.router.boundaries):
                return False
            if not force:
                shares = self.router.shard_shares()
                if len(shares) == 0 or shares.max() \
                        <= self.rebalance_factor / self.n_shards:
                    return False
            self._migrate(new_b)
            return True

    def _migrate(self, new_boundaries: np.ndarray) -> None:
        """Rebuild the shard set under new boundaries (``_mutex`` held)."""
        old_shards = self._shard_list()
        for s in old_shards:                      # settle: buffers empty
            s.flush()
        gen = self._generation + 1
        new_dirs: List[str] = []
        stores: List = [None] * self.n_shards
        if self._shard_dir is not None:
            new_dirs = [self._shard_dir.shard_dir_name(i, gen)
                        for i in range(self.n_shards)]
            stores = [self._shard_dir.shard_store(d) for d in new_dirs]
        new_shards: List[CoconutLSM] = []
        try:
            for i in range(self.n_shards):
                new_shards.append(
                    CoconutLSM(self.cfg,
                               buffer_capacity=self.buffer_capacity,
                               leaf_size=self.leaf_size,
                               size_ratio=self.size_ratio,
                               mode=self.mode,
                               materialized=self.materialized,
                               io=self.io, store=stores[i],
                               concurrent=self.concurrent,
                               wal_fsync=self.wal_fsync,
                               max_debt=self.max_debt,
                               tiers=self.tiers, device=self.device))
            # detach the fill-phase WALs: the OLD generation stays the
            # authoritative durable copy until the SHARDS.json switch (a
            # crash before it orphans the new dirs entirely), so logging +
            # fsyncing every migrated row would be pure wasted I/O
            for s in new_shards:
                if s.wal is not None:
                    s.wal.close()
                    s.wal = None
            router = KeyRangeRouter(self.cfg, self.n_shards,
                                    boundaries=new_boundaries,
                                    sample_cap=self.router.sample_cap)
            router._sample = self.router._sample.copy()
            router._seen = self.router._seen
            # re-route every row, preserving global ids and timestamps;
            # the trees already hold sorted paas/codes, so nothing
            # re-summarizes.  The rows come to the host (an insert takes
            # host rows); the summaries stay on the device
            for src in old_shards:
                for r in src.runs:
                    t = r.tree
                    raw = (t.raw if t.raw is not None
                           else t.raw_ref[t.offsets]).cpu().numpy()
                    ts = t.timestamps.cpu().numpy().astype(np.int64)
                    ids = t.ids.cpu().numpy().astype(np.int64)
                    keys = t.keys.cpu().numpy().astype(np.uint32)
                    dest = router.route(keys)
                    for si in range(self.n_shards):
                        m = dest == si
                        if not m.any():
                            continue
                        rows = torch.from_numpy(np.nonzero(m)[0]).to(
                            t.device)
                        new_shards[si].insert(
                            raw[m], ts[m], ids=ids[m],
                            key_fence=key_fence_of(keys[m]),
                            summaries=(t.paas[rows], t.codes[rows]))
            for i, s in enumerate(new_shards):    # commit new manifests
                s.advance_clock(self.clock)
                s.flush()
                if stores[i] is not None:         # re-arm the WAL for
                    from ..ingest.wal import WriteAheadLog
                    s.wal = WriteAheadLog(stores[i].root,
                                          fsync=self.wal_fsync,
                                          io=s.io, metrics=s.ingest)
                    s._rotate_wal()               # post-switch inserts
                s.debt_cv = self._debt_cv
        except BaseException:
            # a failed fill must not wedge the NEXT attempt: retire the
            # half-built generation in-process (its dirs would otherwise
            # trip the 'already holds a committed index' guard on retry;
            # the old generation was never touched and keeps serving)
            for s in new_shards:
                try:
                    s.close()
                except BaseException:
                    pass
            if self._shard_dir is not None:
                import shutil
                for d in new_dirs:
                    shutil.rmtree(
                        os.path.join(self._shard_dir.root, d),
                        ignore_errors=True)
            raise
        with self._state_lock:                    # the switch
            self._shards = new_shards
            self.router = router
            self._generation = gen
            old_dirs, self._dirs = self._dirs, new_dirs
        self._commit_meta()                       # atomic commit point
        for s in old_shards:
            # drop the retired generation's cached leaf blocks before the
            # dirs are deleted (tokens are segment paths, so this frees
            # the shared budget; the new generation re-warms on demand)
            if self.tiers is not None and s.store is not None:
                for r in s.runs:
                    if r.segment:
                        self.tiers.invalidate(
                            os.path.join(s.store.root, r.segment))
            s.close()
        if self._shard_dir is not None:
            self._shard_dir.cleanup()             # retire old generation

    # --------------------------------------------------------------- lifetime
    def close(self) -> None:
        """Drain + stop every shard's compactor and close the WAL handles.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        for s in self._shard_list():
            s.close()

    def __enter__(self) -> "ShardedCoconutLSM":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------------- read
    @property
    def n(self) -> int:
        return sum(s.n for s in self._shard_list())

    @property
    def runs(self) -> List:
        """Flattened run list across shards (diagnostics)."""
        return [r for s in self._shard_list() for r in s.runs]

    def ingest_lag(self) -> int:
        return sum(s.ingest_lag() for s in self._shard_list())

    def compaction_debt(self) -> int:
        return sum(s.compaction_debt() for s in self._shard_list())

    def level_histogram(self) -> dict:
        hist: dict = {}
        for s in self._shard_list():
            for level, cnt in s.level_histogram().items():
                hist[level] = hist.get(level, 0) + cnt
        return hist

    def check_invariants(self) -> None:
        for s in self._shard_list():
            s.check_invariants()

    def shard_sizes(self) -> List[int]:
        return [s.n for s in self._shard_list()]

    def describe(self) -> str:
        if self._shard_dir is not None:
            return self._shard_dir.describe()
        return (f"ShardedCoconutLSM({self.n_shards} shards, "
                f"{self.n} entries, sizes={self.shard_sizes()})")

    # ---------------------------------------------------------------- search
    def _snapshots(self):
        """Atomic multi-shard snapshot set (plus the router that routed
        it, plus the even insert epoch the set was cut at — the
        ``snapshot_epoch`` field of the probe's query-log record): no
        routed insert batch is ever half-visible across shards.

        Fast path: capture shard snapshots between insert epochs (the
        epoch is odd while a batch is mid-flight and bumps when it
        settles) and retry on a race — snapshot capture is reference-only,
        so retries are cheap and writers are never blocked.  Bounded
        fallback: briefly hold the ingest mutex for a guaranteed cut."""
        for _ in range(16):
            with self._state_lock:
                e0 = self._epoch
                shards = list(self._shards)
                router = self.router
            if e0 % 2 == 0:
                snaps = [s.snapshot() for s in shards]
                with self._state_lock:
                    if self._epoch == e0 and shards == self._shards:
                        return snaps, router, e0
            time.sleep(0.001)
        with self._mutex:                # excludes inserts + migrations
            with self._state_lock:
                shards = list(self._shards)
                router = self.router
                e0 = self._epoch         # even: no insert under _mutex
            return [s.snapshot() for s in shards], router, e0

    def _fence_bounds(self, snaps, q_paas: np.ndarray) -> np.ndarray:
        """[n_snaps, Q] mindist lower bounds from each shard's key fence
        (inf for empty shards — nothing to search; 0 when the fence is
        unknown — never prune what we cannot bound)."""
        nq = q_paas.shape[0]
        bounds = np.zeros((len(snaps), nq), np.float32)
        for i, sn in enumerate(snaps):
            if sn.n == 0:
                bounds[i] = np.inf
            elif sn.key_fence is not None:
                clo, chi = key_range_code_bounds(*sn.key_fence, self.cfg)
                bounds[i] = fence_mindist_sq(q_paas, clo, chi, self.cfg)
        return bounds

    def search_exact_batch(self, queries: np.ndarray, *,
                           k: int = 1,
                           window: Optional[int] = None,
                           radius_leaves: int = 1,
                           budget=None,
                           mode: str = "exact",
                           scan_mode: Optional[str] = None
                           ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Batched exact k-NN across shards, cheapest-shard-first.

        Per-shard fence bounds order the visit; each shard runs the
        unified query pipeline over its snapshot, the merged pool's k-th
        best seeds every later shard's scan (``bsf=``), and shards whose
        bound cannot beat it are pruned whole.  Answers (distance bits
        AND global ids) are identical for any shard count.

        ``scan_mode`` overrides the engine default per call:
        ``"mesh"`` routes the batch through the device-resident launch
        (pinned shard columns, one ``scan_verify`` per sub-shard and a
        selection merge; buffers are brute-forced first and their k-th
        distances seed the launch bound), and
        transparently falls back to the threaded fan-out whenever the
        batch cannot run on device — budgeted/approx probes, snapshots
        whose ids/timestamps do not fit the pinned int32 columns, or a
        pin-budget miss — so answers stay exact either way.

        ``budget`` / ``mode="approx"``: the global
        :class:`repro_torch.query.Budget` is *split* across shards — each
        shard visited gets a slice of the remaining leaf/byte allowance
        proportional to its share of the not-yet-visited leaves (with
        carryover: what a shard leaves unspent returns to the pool), and
        ``deadline_ms`` becomes one global wall-clock cutoff.  The
        per-shard ``lb_unvisited`` reports are combined min-wise and the
        gap recomputed against the globally merged k-th distance, so the
        certificate ``exact_kth >= kth - gap`` holds across the whole
        engine; shards pruned by the fence chain contribute nothing
        (every row there is bounded below by the chained bsf, which is
        never below the final merged k-th).  The info dict gains ``gap``
        / ``lb_unvisited`` / ``budget_exhausted``.
        """
        from ..query import Budget, as_budget
        if mode not in ("exact", "approx"):
            raise ValueError(
                f"mode must be 'exact' or 'approx', got {mode!r}")
        sm = scan_mode if scan_mode is not None else self.scan_mode
        if sm not in ("threaded", "mesh"):
            raise ValueError(
                f"scan_mode must be 'threaded' or 'mesh', got {sm!r}")
        budget = as_budget(budget)
        approx = budget is not None or mode == "approx"
        if approx and budget is None:
            budget = Budget()
        queries = _queries_np(queries)
        nq = queries.shape[0]
        with probe("sharded." + ("approx" if approx else "exact"),
                   queries=nq, k=k, window=window,
                   budget=budget if approx else None,
                   shards=self.n_shards) as rec:
            if sm == "mesh":
                eng = self._mesh_engine_get()
                if approx:
                    # the budgeted drain is a host-side leaf-frontier
                    # policy — there is no device twin; take the seam
                    eng.fallback("approx")
                else:
                    out = self._fanout_mesh(queries, rec, k=k,
                                            window=window)
                    if out is not None:
                        return out
            return self._fanout(queries, rec, k=k, window=window,
                                radius_leaves=radius_leaves,
                                budget=budget, approx=approx)

    def _mesh_engine_get(self):
        """The lazily-built :class:`~repro_torch.query.mesh.MeshScanEngine`,
        subscribed to the tiered store's invalidation feed so segment GC
        (flush / merge / rebalance) eagerly drops pinned device state."""
        with self._mesh_engine_lock:
            if self._mesh_engine is None:
                from ..query.mesh import MeshScanEngine
                eng = MeshScanEngine(self.cfg, device=self.device)
                if self.tiers is not None:
                    self.tiers.add_invalidation_hook(eng.on_invalidate)
                self._mesh_engine = eng
            return self._mesh_engine

    def _fanout_mesh(self, queries: np.ndarray, rec: dict, *, k: int,
                     window: Optional[int]
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, dict]]:
        """One device-resident pass over all shards, or None when the
        batch must take the threaded seam instead.

        bsf chaining is preserved with the roles flipped: the frozen
        buffers (never device-resident — they mutate every insert) are
        brute-forced FIRST with the same ``buffer_topk``
        kernel the threaded executor uses, and their per-query k-th
        distances become the launch's strict ``md < bound`` cut — the
        one-launch analogue of seeding every shard's scan with the
        merged pool so far.  The launch's answers then merge into the
        buffer pool with the same stable ``merge_pools``.
        """
        from ..query.executor import buffer_topk
        eng = self._mesh_engine_get()
        nq = queries.shape[0]
        snaps, router, epoch = self._snapshots()
        rec["snapshot_epoch"] = epoch
        pinned = eng.pin(snaps)
        if pinned is None:
            eng.fallback("unpinnable")
            return None
        if window is not None and not pinned.has_ts:
            eng.fallback("no_timestamps")
            return None
        ts_min = None
        if window is not None:
            ts_min = np.asarray([sn.clock - window for sn in snaps],
                                np.int64)
            if ts_min.size and int(ts_min.max()) > np.iinfo(np.int32).max:
                eng.fallback("window_range")
                return None
            ts_min = np.clip(ts_min, np.iinfo(np.int32).min,
                             np.iinfo(np.int32).max).astype(np.int32)
        queries_t = torch.from_numpy(queries).to(self.device)
        q_paas = S.paa(queries_t, self.cfg.segments).cpu().numpy()
        stats = SearchStats(candidates=0, exact=True, queries=nq)
        info = {"partitions_touched": 0, "partitions_pruned": 0,
                "buffer_rows": 0}

        # the buffer pool first (its k-th bits seed the launch)
        buf_rows, buf_ids, buf_per_shard = [], [], [0] * len(snaps)
        for si, sn in enumerate(snaps):
            b = sn.buffer
            if b is None or b.n == 0:
                continue
            rows, ids, ts = b.raw, b.ids, b.ts
            if window is not None:
                keep = np.nonzero(ts >= (sn.clock - window))[0]
                rows, ids = rows[keep], ids[keep]
            if len(rows) == 0:
                continue
            buf_rows.append(rows)
            buf_ids.append(ids)
            buf_per_shard[si] = len(rows)
        best_d = np.full((nq, k), np.inf, np.float32)
        best_off = np.full((nq, k), -1, np.int64)
        if buf_rows:
            rows = np.concatenate(buf_rows, axis=0)
            ids = np.concatenate(buf_ids, axis=0)
            with _span("buffer", rows=len(rows)):
                best_d, best_off = buffer_topk(
                    queries_t, rows, ids, k, io=self.io)
            stats.buffer_rows = len(rows)
            info["buffer_rows"] = len(rows)
            info["partitions_touched"] += sum(
                1 for n_ in buf_per_shard if n_)
        bound = best_d[:, -1].copy()

        with _span("mesh_launch", shards=len(snaps),
                   devices=pinned.layout.n_devices,
                   sub_shards=pinned.layout.shards_per_device,
                   queries=nq, rows=sum(pinned.rows)) as msp:
            d, ids64, counts = eng.launch(pinned, queries_t, q_paas,
                                          ts_min, bound, k=k)
            msp.set(candidates=int(counts.sum()))
        best_d, best_off = merge_pools(best_d, best_off, d, ids64, k)

        # stats attribution per shard: the launch scans every pinned
        # leaf (device residency trades the fence skip for zero
        # host orchestration), so leaves_scanned is the pinned total
        # and counts carries the per-shard verified rows
        reg = get_registry()
        per_query = counts.sum(axis=0).astype(np.int64)
        for si in range(len(snaps)):
            if pinned.rows[si] == 0 and buf_per_shard[si] == 0:
                continue
            reg.counter(f"shard.s{si}.queries_total").inc(nq)
            reg.counter(f"shard.s{si}.leaves_scanned_total").inc(
                int(pinned.leaves[si]))
        stats.candidates = int(counts.sum()) + stats.buffer_rows
        stats.candidates_per_query = per_query + stats.buffer_rows
        stats.leaves_scanned = int(sum(pinned.leaves))
        stats.leaves_per_query = np.full(
            nq, stats.leaves_scanned, np.int64)
        stats.leaves_touched = stats.leaves_scanned
        stats.partitions_touched = sum(
            len(sn.runs) for sn in snaps)
        stats.shards_touched = sum(
            1 for si in range(len(snaps))
            if pinned.rows[si] or buf_per_shard[si])
        info["partitions_touched"] += stats.partitions_touched
        info.update(candidates=stats.candidates,
                    candidates_per_query=stats.candidates_per_query,
                    leaves_per_query=stats.leaves_per_query,
                    leaves_pruned=stats.leaves_pruned,
                    leaves_scanned=stats.leaves_scanned,
                    shards_touched=stats.shards_touched,
                    shards_pruned=stats.shards_pruned,
                    stats=stats)
        info["scan_mode"] = "mesh"
        info["mesh_devices"] = pinned.layout.n_devices
        rec["stats"] = stats
        rec["scan_mode"] = "mesh"
        rec["mesh_devices"] = pinned.layout.n_devices
        return best_d, best_off, info

    def _fanout(self, queries: np.ndarray, rec: dict, *, k: int,
                window: Optional[int], radius_leaves: int,
                budget, approx: bool) -> Tuple[np.ndarray, np.ndarray,
                                               dict]:
        """The fan-out body of :meth:`search_exact_batch`, inside the
        probe scope (``rec`` is the probe's query-log record)."""
        from ..query import Budget
        nq = queries.shape[0]
        snaps, router, epoch = self._snapshots()
        rec["snapshot_epoch"] = epoch
        q_paas_t = S.paa(torch.from_numpy(queries).to(self.device),
                         self.cfg.segments)
        q_paas = q_paas_t.cpu().numpy()
        bounds = self._fence_bounds(snaps, q_paas)      # [S, Q]
        # each query's HOME shard: where its z-order key routes — by the
        # locality argument of Algorithm 4 the most promising shard
        q_keys = S.invsax_keys(S.sax_encode(q_paas_t, self.cfg.bits),
                               self.cfg).cpu().numpy().astype(np.uint32)
        home_of = router.route(q_keys)                  # [Q]

        best_d = np.full((nq, k), np.inf, np.float32)
        best_off = np.full((nq, k), -1, np.int64)
        bound_vec = np.full(nq, np.inf, np.float32)
        stats = SearchStats(candidates=0, exact=True, queries=nq)
        stats.candidates_per_query = np.zeros(nq, np.int64)
        stats.leaves_per_query = np.zeros(nq, np.int64)
        info = {"partitions_touched": 0, "partitions_pruned": 0,
                "buffer_rows": 0}
        scanned = set()

        # --- budget split state (approx only) ---------------------------
        shard_leaves = np.array(
            [sum(r.tree.n_leaves for r in sn.runs) for sn in snaps],
            np.int64)
        unvisited_leaves = int(shard_leaves.sum())
        rem = {"leaves": budget.max_leaves if approx else None,
               "bytes": budget.max_bytes if approx else None,
               "unvisited": unvisited_leaves}
        t_end = None
        if approx and budget.deadline_ms is not None:
            t_end = time.perf_counter() + budget.deadline_ms / 1e3
        lb_un_g = np.full(nq, np.inf, np.float32)

        def shard_budget(si: int) -> Budget:
            """Proportional slice of the remaining allowance: this
            shard's leaves over all not-yet-visited leaves."""
            share = (shard_leaves[si] / max(rem["unvisited"], 1)
                     if rem["unvisited"] else 1.0)
            lv = (None if rem["leaves"] is None
                  else int(np.ceil(rem["leaves"] * share)))
            by = (None if rem["bytes"] is None
                  else int(np.ceil(rem["bytes"] * share)))
            dl = None
            if t_end is not None:
                dl = max(0.0, (t_end - time.perf_counter()) * 1e3)
            return Budget(max_leaves=lv, max_bytes=by, deadline_ms=dl)

        def scan(si: int, qsel: np.ndarray) -> None:
            """Run one shard's pipeline over a query subset and fold its
            pools into the global chain."""
            sn = snaps[si]
            idx = np.nonzero(qsel)[0]
            kw = {}
            if approx:
                kw = dict(budget=shard_budget(si), mode="approx")
            with _span("shard", shard=si, queries=len(idx)) as ssp:
                d, off, sub = sn.search_exact_batch(
                    queries[idx], k=k, window=window,
                    radius_leaves=radius_leaves, bsf=bound_vec[idx].copy(),
                    **kw)
                sst = sub["stats"]
                ssp.set(leaves_scanned=sst.leaves_scanned,
                        leaves_pruned=sst.leaves_pruned,
                        scan_bytes=sst.scan_bytes,
                        candidates=sst.candidates,
                        buffer_rows=sst.buffer_rows)
                # per-shard query-load counters: with the rows_total /
                # size_rows write-side pair, the full skew picture
                reg = get_registry()
                reg.counter(f"shard.s{si}.queries_total").inc(len(idx))
                reg.counter(f"shard.s{si}.leaves_scanned_total").inc(
                    int(sst.leaves_scanned))
                reg.counter(f"shard.s{si}.scan_bytes_total").inc(
                    int(sst.scan_bytes))
                if approx:
                    # carryover: return the unspent slice to the pool
                    if rem["leaves"] is not None:
                        rem["leaves"] = max(
                            0, rem["leaves"] - sst.leaves_scanned)
                    if rem["bytes"] is not None:
                        rem["bytes"] = max(
                            0, rem["bytes"] - sst.scan_bytes)
                    rem["unvisited"] -= int(shard_leaves[si])
                    lb_un_g[idx] = np.minimum(lb_un_g[idx],
                                              sub["lb_unvisited"])
                    ssp.set(budget_leaves_left=rem["leaves"],
                            budget_bytes_left=rem["bytes"],
                            gap_max=(float(sub["gap"].max())
                                     if len(sub["gap"]) else 0.0))
                # shard-tag the touched-leaf report before the merge so
                # hot-leaf analysis can attribute leaves to their shard
                sst.leaf_touches = {f"s{si}/{p}": v
                                    for p, v in sst.leaf_touches.items()}
                stats.merge(sst)
                stats.candidates += sst.buffer_rows  # historical:
                # info-level "candidates" includes brute-forced buffer rows
                stats.candidates_per_query[idx] += \
                    sub["candidates_per_query"]
                stats.leaves_per_query[idx] += sub["leaves_per_query"]
                info["partitions_touched"] += sub["partitions_touched"]
                info["partitions_pruned"] += sub["partitions_pruned"]
                info["buffer_rows"] += sub["buffer_rows"]
                with _span("merge", shard=si, queries=len(idx)):
                    md, mo = merge_pools(best_d[idx], best_off[idx],
                                         d, off, k)
                    best_d[idx], best_off[idx] = md, mo
                    bound_vec[idx] = md[:, -1]

        # phase 1 — cheapest shard first, per query: every query scans
        # its home shard (disjoint sub-batches), seeding a near-optimal
        # per-query bsf before any cold shard is touched
        for si in np.argsort(-np.bincount(home_of, minlength=len(snaps))):
            si = int(si)
            qsel = (home_of == si) & np.isfinite(bounds[si])
            if snaps[si].n == 0 or not qsel.any():
                continue
            scan(si, qsel)
            scanned.add(si)
        # phase 2 — remaining (shard, query) pairs, cheapest bound first;
        # a shard is pruned whole when no query's fence bound can beat
        # the chained bsf (strict: mindist >= bsf cannot improve d < bsf).
        # Empty shards are skipped silently — "nothing there" is not a
        # fence prune and must not inflate the observability metric.
        for si in np.argsort(bounds.mean(axis=1), kind="stable"):
            si = int(si)
            if snaps[si].n == 0:
                continue
            qsel = (home_of != si) & (bounds[si] < bound_vec)
            if not qsel.any():
                if si not in scanned:
                    stats.shards_pruned += 1
                    stats.leaves_pruned += sum(
                        r.tree.n_leaves for r in snaps[si].runs)
                continue
            scan(si, qsel)
            scanned.add(si)
        stats.shards_touched = len(scanned)
        if approx:
            # global certificate: min-combined unvisited bound vs the
            # merged k-th; inf means every leaf everywhere was visited
            from ..query import certified_gap
            gap = certified_gap(best_d[:, -1], lb_un_g)
            stats.gap = gap
            stats.lb_unvisited = lb_un_g
            stats.exact = bool(np.all(gap == 0.0))
            info["gap"] = gap
            info["lb_unvisited"] = lb_un_g
            info["budget_exhausted"] = stats.budget_exhausted
        info.update(candidates=stats.candidates,
                    candidates_per_query=stats.candidates_per_query,
                    leaves_per_query=stats.leaves_per_query,
                    leaves_pruned=stats.leaves_pruned,
                    leaves_scanned=stats.leaves_scanned,
                    shards_touched=stats.shards_touched,
                    shards_pruned=stats.shards_pruned,
                    stats=stats)
        rec["stats"] = stats
        return best_d, best_off, info

    def search_approx_batch(self, queries: np.ndarray, *,
                            k: int = 1,
                            window: Optional[int] = None,
                            radius_leaves: int = 1,
                            budget=None
                            ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Batched approximate k-NN: every non-empty shard probes the
        leaves around the query's insertion point; pools merge.

        ``budget`` is passed through *per shard* (each shard may spend
        up to the whole allowance — the historical probe-per-run shape,
        not the split-budget drain of ``search_exact_batch``); the
        per-shard ``lb_unvisited`` reports combine min-wise and the gap
        is recomputed against the merged k-th distance.
        """
        from ..query import as_budget
        queries = _queries_np(queries)
        nq = queries.shape[0]
        with probe("sharded.probe", queries=nq, k=k, window=window,
                   budget=as_budget(budget),
                   shards=self.n_shards) as rec:
            snaps, _, epoch = self._snapshots()
            rec["snapshot_epoch"] = epoch
            best_d = np.full((nq, k), np.inf, np.float32)
            best_off = np.full((nq, k), -1, np.int64)
            cands_pq = np.zeros(nq, np.int64)
            lb_un_g = np.full(nq, np.inf, np.float32)
            exhausted = False
            info = {"partitions_touched": 0, "buffer_rows": 0,
                    "shards_touched": 0, "shards_pruned": 0}
            for si, sn in enumerate(snaps):
                if sn.n == 0:    # nothing there — not a prune
                    continue
                with _span("shard", shard=si, queries=nq):
                    d, off, sub = sn.search_approx_batch(
                        queries, k=k, window=window,
                        radius_leaves=radius_leaves, budget=budget)
                info["shards_touched"] += 1
                info["partitions_touched"] += sub["partitions_touched"]
                info["buffer_rows"] += sub["buffer_rows"]
                cands_pq += sub["candidates_per_query"]
                lb_un_g = np.minimum(lb_un_g, sub["lb_unvisited"])
                exhausted = exhausted or sub["budget_exhausted"]
                with _span("merge", shard=si, queries=nq):
                    best_d, best_off = merge_pools(best_d, best_off,
                                                   d, off, k)
            from ..query import certified_gap
            gap = certified_gap(best_d[:, -1], lb_un_g)
            info["candidates_per_query"] = cands_pq
            info["gap"] = gap
            info["lb_unvisited"] = lb_un_g
            info["budget_exhausted"] = exhausted
        return best_d, best_off, info

    def search_exact(self, query: np.ndarray, *,
                     k: int = 1,
                     window: Optional[int] = None,
                     radius_leaves: int = 1,
                     budget=None,
                     mode: str = "exact"
                     ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Exact k-NN for one query (Q=1 wrapper over the batched
        pipeline; returns length-k arrays)."""
        q = _queries_np(query)[:1]
        d, off, info = self.search_exact_batch(
            q, k=k, window=window, radius_leaves=radius_leaves,
            budget=budget, mode=mode)
        return d[0], off[0], info

    def search_approx(self, query: np.ndarray, *,
                      k: int = 1,
                      window: Optional[int] = None,
                      radius_leaves: int = 1,
                      budget=None
                      ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Approximate k-NN for one query (Q=1 wrapper; returns
        length-k arrays)."""
        q = _queries_np(query)[:1]
        d, off, info = self.search_approx_batch(
            q, k=k, window=window, radius_leaves=radius_leaves,
            budget=budget)
        return d[0], off[0], info
