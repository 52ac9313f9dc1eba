"""Coconut-LSM (Sec. 4.4): the first write-optimized data-series index.

Incoming series are buffered; each buffer flush becomes a sorted run (a
Coconut-Tree).  Runs are organized in levels of exponentially increasing
capacity with size ratio ``r=2`` and sort-merged as levels fill, bounding the
run count at O(log2 N) and the amortized insert cost at O(log2(N)/B) block
transfers — only possible because sortable summarizations allow *merging*
temporal partitions instead of re-inserting them top-down.

Window-query modes (Sec. 5) are implemented on this one structure:
  * ``pp``  — post-processing: merge everything into one run; filter by
    timestamp after retrieval (the only option for unsortable baselines).
  * ``tp``  — temporal partitioning: never merge; one run per flush.
  * ``btp`` — bounded temporal partitioning (the paper's contribution):
    ratio-2 merging; window queries skip runs older than the window.

The runs' trees live on the engine's device — the card unless the engine
is made with ``device="cpu"``; without CUDA and no explicit CPU request
the constructor raises.  A flush builds its run with :func:`tree.build`
there (the ``fused_build`` kernel, or ``zorder`` when every buffered part
was inserted with its ``summaries=``); a merge is :func:`tree.merge_trees`
there.  The buffer stays on the host until its flush.

With a :class:`repro_torch.storage.store.SegmentStore` attached, every
flush and merge also lands on disk: new runs are written as segment
files (each column copied from the card to the host first) and the
manifest is atomically committed once per flush, so the index survives
process restart (``CoconutLSM.open``) and a crash anywhere replays
cleanly from the last committed manifest.  The buffer is covered by a
write-ahead log (:mod:`repro_torch.ingest.wal`) beside the segments:
every ``insert`` is logged before it is acknowledged and replayed on
reopen, so acked-but-unflushed rows survive a crash too.  Store, manifest
and log are byte-compatible with the reference's, so either package
reopens the other's index.

With ``concurrent=True`` the engine moves flushes, merges and manifest
commits onto a background worker (:mod:`repro_torch.ingest.compactor`):
``insert`` only appends to the WAL and the buffer (with bounded-debt
backpressure), and every
``search_*``/``search_*_batch`` runs against an immutable
:class:`repro_torch.ingest.snapshot.Snapshot` — frozen run list plus a
frozen copy of the buffer — so exact answers are bit-identical to the
synchronous engine while compaction proceeds underneath.  The worker's
kernels go to the same (default) CUDA stream as the caller's, and a
flush or merge is timed to its end on the device before its run is
published, so a snapshot never holds a half-built run.

Every row carries a **global id** (by default its position in this
engine's insert stream), kept per run and reported as the answer
"offset" by every search path; ids are WAL-logged and persisted per
run.  ``insert(ids=, key_fence=)``, the per-run/snapshot key fences,
``search_exact*(bsf=)`` external bounds, ``advance_clock`` and ``debt_cv``
are the hooks a sharded router uses.  Without a store, rows still
buffered at ``close()`` are dropped, as in the reference (in-memory
engines are volatile by contract).

:func:`from_numpy` / :func:`to_numpy` carry an engine's whole state
(runs with their levels and time ranges, the buffer, the clock) across
as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import keys as K
from . import summarization as S
from . import tree as T
from ..obs import get_registry, span as _span, stage
from .metrics import IngestMetrics, IOStats

__all__ = ["CoconutLSM", "Run", "from_numpy", "to_numpy"]


def _combine_fences(fences) -> Optional[Tuple[int, int]]:
    """Combine per-component (lo, hi) z-order bigint fences; ``None``
    anywhere means the range is unknown and poisons the combination."""
    lo = hi = None
    for f in fences:
        if f is None:
            return None
        if lo is None or f[0] < lo:
            lo = f[0]
        if hi is None or f[1] > hi:
            hi = f[1]
    return None if lo is None else (lo, hi)


def _cat(parts, dev: torch.device):
    """Row-wise concatenation of buffered parts: host arrays stay numpy,
    any tensor makes the result a tensor on ``dev``."""
    if any(isinstance(p, torch.Tensor) for p in parts):
        return torch.cat([torch.as_tensor(p).to(dev) for p in parts])
    return np.concatenate(parts)


def _settle(dev: torch.device) -> None:
    """Wait for the device's queued work: flush and merge times are
    device times, and a run is published only when its tensors exist."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Run:
    tree: T.CoconutTree
    level: int
    t_min: int
    t_max: int
    segment: Optional[str] = None   # on-disk segment file (store-backed)
    # open Segment reader for the file above — kept only when a tiered
    # leaf store is attached, so snapshot partitions can serve cached
    # leaf blocks off the (packed) on-disk columns
    seg_handle: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)
    _fence: Optional[Tuple[int, int]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.tree.n

    @property
    def key_fence(self) -> Tuple[int, int]:
        """(lo, hi) z-order key range of the run as python bigints — the
        per-run fence a sharded router's shard-prune bound reads.  The
        tree is key-sorted, so this is just the first and last key
        (computed once; runs are immutable)."""
        if self._fence is None:
            # slice on the device BEFORE the host copy: 2 rows cross the
            # bus, not the whole [N, n_words] key column
            self._fence = (
                K.keys_to_bigint(self.tree.keys[:1].cpu().numpy())[0],
                K.keys_to_bigint(self.tree.keys[-1:].cpu().numpy())[0])
        return self._fence


@dataclasses.dataclass
class _PendingFlush:
    """Buffer head handed to a flush but not yet published as a run.
    Holds *references* to the immutable batch arrays (possibly boundary
    views), so snapshots keep seeing the rows without any copy under the
    engine lock."""
    raw_parts: List[np.ndarray]
    ts_parts: List[np.ndarray]
    id_parts: List[np.ndarray]
    n: int
    fence: Optional[Tuple[int, int]] = None   # combined key range (or None)
    # per-part (paa, codes) given to insert, or None — lets the run build
    # skip its summarize when every part carries them
    sum_parts: Optional[List] = None


class CoconutLSM:
    """Log-structured Coconut index with pluggable windowing mode.

    Thread model: all mutable state (buffer, run list, clock, counters) is
    guarded by one lock; run *contents* are immutable once published, so a
    snapshot only needs the lock long enough to copy the list head.  In
    synchronous mode (default) everything happens on the calling thread;
    with ``concurrent=True`` a single compactor thread owns
    flush/merge/commit and the calling thread only ever appends.
    """

    def __init__(self, cfg: S.SummaryConfig, *,
                 buffer_capacity: int = 4096,
                 leaf_size: int = 256,
                 size_ratio: int = 2,
                 mode: str = "btp",
                 materialized: bool = True,
                 io: Optional[IOStats] = None,
                 store=None,
                 concurrent: bool = False,
                 wal_fsync: str = "always",
                 max_debt: int = 4,
                 tiers=None,
                 device=None):
        if mode not in ("pp", "tp", "btp"):
            raise ValueError(f"unknown windowing mode {mode!r}")
        if store is not None and store.exists():
            raise ValueError(
                f"{store.root} already holds a committed index — reopen it "
                "with CoconutLSM.open(store) instead of building over it")
        self.device = T._device_for(None, device)
        self.cfg = cfg
        self.buffer_capacity = buffer_capacity
        self.leaf_size = leaf_size
        self.size_ratio = size_ratio
        self.mode = mode
        self.materialized = materialized
        self.io = io if io is not None else IOStats(leaf_size)
        self.store = store                 # Optional[SegmentStore]
        if store is not None and store.io is None:
            store.io = self.io             # disk writes charge index stats
        # Optional[repro_torch.storage.tiers.TieredLeafStore]: leaf-block
        # and query-result caching over the committed segments
        self.tiers = tiers if store is not None else None
        # monotone data-visibility epoch: bumped whenever the rows a
        # snapshot could see change (insert, run publish, merge).  The
        # result cache keys on it, so an answer computed against an older
        # view is unreachable the instant the view changes.  (The clock
        # alone is NOT a safe key: a sync-mode insert advances the clock
        # while the rows stay invisible until flush — and the flush
        # itself doesn't advance it.)
        self.data_epoch = 0
        self.runs: List[Run] = []          # newest first
        self._buf_raw: List[np.ndarray] = []
        self._buf_ts: List[np.ndarray] = []
        self._buf_ids: List[np.ndarray] = []
        self._buf_fence: List[Optional[Tuple[int, int]]] = []
        self._buf_sum: List[Optional[Tuple[object, object]]] = []
        self._buf_count = 0
        self.clock = 0                     # logical insertion time
        self.merges = 0
        # -- ingest subsystem state ----------------------------------------
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        # serializes WAL file I/O (append order == buffer order) without
        # holding the engine lock across a disk fsync; ALWAYS acquired
        # before the engine lock, never after (deadlock ordering)
        self._wal_lock = threading.Lock()
        self._flushing: List[_PendingFlush] = []
        self._dirty = False                # runs changed since last commit
        self._rows_inserted = 0            # total rows ever accepted
        self._closed = False
        self.concurrent = concurrent
        self.max_debt = max_debt
        # optional external condition the compactor pokes after every
        # retired debt unit (a sharded router's shared backpressure)
        self.debt_cv: Optional[threading.Condition] = None
        self.ingest = IngestMetrics()
        self.wal = None
        if store is not None:
            from ..ingest.wal import WriteAheadLog
            self.wal = WriteAheadLog(store.root, fsync=wal_fsync,
                                     io=self.io, metrics=self.ingest)
            self._commit()   # empty manifest: the index is reopenable from
            # birth, so a crash before the first flush still replays the WAL
        self._compactor = None
        if concurrent:
            from ..ingest.compactor import Compactor
            self._compactor = Compactor(self)

    # ------------------------------------------------------------ persistence
    @classmethod
    def open(cls, store, *, io: Optional[IOStats] = None,
             concurrent: bool = False,
             wal_fsync: str = "always",
             max_debt: int = 4,
             tiers=None,
             device=None) -> "CoconutLSM":
        """Reopen a persisted index from its manifest (restart/recovery).

        ``store`` is a ``SegmentStore`` or a directory path.  Runs the
        recovery protocol first (drops uncommitted manifest temps and
        orphan segments), rebuilds every run from its segment file with
        ``Segment.to_tree`` on ``device`` (the card unless
        ``device="cpu"``; without CUDA and no explicit CPU request this
        raises), then replays the write-ahead log from the manifest's
        ``wal_start`` so every acknowledged insert — flushed or still
        buffered at crash time — is recovered.  Searches on the reopened
        index are identical to the index that committed the manifest
        plus the replayed tail.  The three stages are timed into the
        registry's ``open.recover_ms``, ``open.load_ms`` and
        ``open.replay_ms``.
        """
        from ..ingest.wal import WriteAheadLog
        from ..storage.store import SegmentStore
        dev = T._device_for(None, device)
        reg = get_registry()
        t0 = time.perf_counter()
        if isinstance(store, str):
            store = SegmentStore(store, io=io)
        store.recover()
        manifest = store.load_manifest()
        if manifest is None:
            raise FileNotFoundError(
                f"no committed manifest in {store.root}")
        t1 = time.perf_counter()
        reg.histogram("open.recover_ms").observe((t1 - t0) * 1e3)
        cfg = SegmentStore.cfg_from_manifest(manifest)
        lsm = cls(cfg,
                  buffer_capacity=manifest["buffer_capacity"],
                  leaf_size=manifest["leaf_size"],
                  size_ratio=manifest["size_ratio"],
                  mode=manifest["mode"],
                  materialized=manifest["materialized"],
                  io=io, store=None, device=dev)
        lsm.store = store
        if store.io is None:
            store.io = lsm.io
        lsm.tiers = tiers
        lsm.clock = manifest["clock"]
        lsm.merges = manifest.get("merges", 0)
        for entry in manifest["runs"]:     # manifest keeps newest-first
            seg = store.open_segment(entry["file"])
            try:
                tree = seg.to_tree(device=dev)
            finally:
                if tiers is None:
                    seg.close()
            lsm.runs.append(Run(tree=tree, level=entry["level"],
                                t_min=entry["t_min"], t_max=entry["t_max"],
                                segment=entry["file"],
                                seg_handle=seg if tiers is not None
                                else None))
        # pre-ids stores (segments without an ids column): synthesize
        # unique global ids — oldest-first run bases + the run's own
        # offsets (unique within a run) — so merges with new id-carrying
        # runs never silently drop the column and report ambiguous
        # component-local offsets as ids
        if any(r.tree.ids is None for r in lsm.runs):
            base = 0
            for r in reversed(lsm.runs):   # oldest first
                if r.tree.ids is None:
                    r.tree.ids = base + r.tree.offsets
                base += r.n
        _settle(dev)
        t2 = time.perf_counter()
        reg.histogram("open.load_ms").observe((t2 - t1) * 1e3)
        durable = sum(r.n for r in lsm.runs)
        lsm._rows_inserted = durable
        # -- WAL replay: recover the acked-but-uncommitted insert tail ------
        wal_start = manifest.get("wal_start", durable)
        tail = WriteAheadLog.replay(store.root, wal_start)
        for raw, ts, ids in tail:
            if len(raw):
                lsm.ingest.add("wal_replayed_rows", len(raw))
                # ids ride in the WAL record so a replayed row keeps the
                # global id it was acked with (sharded engines route ids
                # that are NOT the shard-local stream position)
                lsm.insert(raw, ts, ids=ids)   # may flush+commit, WAL-less
        lsm.clock = max(lsm.clock, manifest["clock"])
        # fresh WAL holding exactly the still-buffered tail; supersedes and
        # deletes the replayed files
        lsm.wal = WriteAheadLog(store.root, fsync=wal_fsync,
                                io=lsm.io, metrics=lsm.ingest)
        lsm._rotate_wal()
        _settle(dev)
        reg.histogram("open.replay_ms").observe(
            (time.perf_counter() - t2) * 1e3)
        if concurrent:
            from ..ingest.compactor import Compactor
            lsm.concurrent = True
            lsm.max_debt = max_debt
            lsm._compactor = Compactor(lsm)
        return lsm

    def _rotate_wal(self) -> None:
        """Supersede the WAL with one record per still-buffered batch.
        Called with the manifest already committed.  Takes the WAL lock
        first (same ordering as ``insert``) so no append can race the file
        swap, then the engine lock only to capture the buffered tail."""
        if self.wal is None:
            return
        with self._wal_lock:
            with self._lock:             # reference capture only
                durable = sum(r.n for r in self.runs)
                parts = []
                for e in self._flushing:
                    parts.extend(zip(e.raw_parts, e.ts_parts, e.id_parts))
                parts.extend(zip(self._buf_raw, self._buf_ts,
                                 self._buf_ids))
            tail = []
            row = durable
            for raw, ts, ids in parts:
                tail.append((row, raw, ts, ids))
                row += len(raw)
            # file I/O outside the engine lock; _wal_lock keeps appends out
            self.wal.rotate(tail)

    def _commit(self) -> None:
        """Atomically publish the current run set, then GC retired files
        and rotate the WAL down to the still-buffered tail.  Without a
        store there is nothing to write: the run set is simply no longer
        dirty.

        Segments are written HERE, after compaction settles, so a flush
        that cascades through several merge levels persists only the runs
        that survive — transient intermediate runs never hit disk.  Each
        new run's columns are copied from its device to the host by
        ``write_segment``.
        """
        with self._lock:
            self._dirty = False
            runs = list(self.runs)
        if self.store is None:
            return
        t0 = time.perf_counter()
        with _span("compact.commit", runs=len(runs)):
            from ..storage.store import SegmentStore
            for r in runs:
                if r.segment is None:
                    r.segment = self.store.write_tree(r.tree)
                if self.tiers is not None and r.seg_handle is None:
                    r.seg_handle = self.store.open_segment(r.segment)
            manifest = SegmentStore.manifest_for(
                self.cfg,
                [{"file": r.segment, "level": r.level,
                  "t_min": r.t_min, "t_max": r.t_max} for r in runs],
                clock=self.clock, mode=self.mode,
                buffer_capacity=self.buffer_capacity,
                leaf_size=self.leaf_size, size_ratio=self.size_ratio,
                materialized=self.materialized, merges=self.merges,
                wal_start=sum(r.n for r in runs))
            self.store.commit_manifest(manifest)
            removed = self.store.gc()
            if self.tiers is not None:
                # retired segment files can never be read again (ids are
                # never reused) — drop their cached leaf blocks
                for f in removed or ():
                    self.tiers.invalidate(os.path.join(self.store.root, f))
            self.ingest.add("commits")
            self._rotate_wal()
        get_registry().histogram("compact.commit_ms").observe(
            (time.perf_counter() - t0) * 1e3)

    # ------------------------------------------------------------------ write
    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("CoconutLSM is closed")

    def insert(self, raw,
               timestamps: Optional[np.ndarray] = None, *,
               ids: Optional[np.ndarray] = None,
               key_fence: Optional[Tuple[int, int]] = None,
               summaries=None) -> None:
        """Insert a batch of series ``[n, L]`` (host rows; a tensor is
        copied to the host).

        Synchronous mode: buffered, may trigger an inline flush + merge
        cascade.  Concurrent mode: logged to the WAL and buffered, then
        the compactor is signalled; the call blocks only when compaction
        debt exceeds ``max_debt`` (backpressure).  On return the batch is
        acked: with a store and ``wal_fsync="always"`` it survives a crash.

        ``ids``: global row ids for the batch; defaults to this engine's
        insert-stream positions.
        ``key_fence``: optional (lo, hi) z-order bigint range covering the
        batch — lets snapshots expose a key fence while rows are still
        buffered.
        ``summaries``: optional (paa ``[n, w]``, codes ``[n, w]``) for the
        batch, as ``ops.sax_summarize`` gives them (host arrays or
        tensors) — the flush-time run build then keys the codes with
        ``zorder`` instead of summarizing the rows a second time.
        """
        self._check_open()
        if self._compactor is not None:
            self._compactor.check()
        if isinstance(raw, torch.Tensor):
            raw = raw.detach().cpu().numpy()
        raw = np.asarray(raw, np.float32)
        n = raw.shape[0]
        with self._wal_lock:           # fixes WAL record order == FIFO order
            with self._cv:
                if timestamps is None:
                    timestamps = np.arange(self.clock, self.clock + n,
                                           dtype=np.int64)
                else:
                    timestamps = np.asarray(timestamps, np.int64)
                # monotone: out-of-order caller timestamps never regress
                # the clock (a regressing clock would shift window cuts)
                self.clock = max(self.clock, int(timestamps.max()) + 1)
                self.data_epoch += 1
                start_row = self._rows_inserted
                self._rows_inserted += n
                if ids is None:
                    ids = np.arange(start_row, start_row + n,
                                    dtype=np.int64)
                else:
                    ids = np.asarray(ids, np.int64)
                self._buf_raw.append(raw)
                self._buf_ts.append(timestamps)
                self._buf_ids.append(ids)
                self._buf_fence.append(key_fence)
                self._buf_sum.append(summaries)
                self._buf_count += n
                self.ingest.add("rows_ingested", n)
                self.ingest.set_gauge("ingest_lag_rows", self._lag_locked())
                if self.concurrent:
                    self._cv.notify_all()
            # the disk write + fsync happens OUTSIDE the engine lock, so
            # snapshots and the compactor never wait on an insert's sync.
            # (If a flush commits these rows before the record lands, the
            # manifest's wal_start simply skips it at replay.)
            if self.wal is not None:
                self.wal.append(raw, timestamps, start_row, ids=ids)
        if self.concurrent:
            with self._cv:             # bounded-debt backpressure
                throttled = False
                while (self._debt_locked() > self.max_debt
                       and self._compactor.error is None
                       and self._compactor.alive):
                    if not throttled:
                        self.ingest.add("backpressure_waits")
                        throttled = True
                    self._cv.wait(timeout=0.5)
            self._compactor.check()
        else:
            while self._buf_count >= self.buffer_capacity:
                self._flush()

    def flush(self) -> None:
        """Force-flush the in-memory buffer.

        In concurrent mode this drains the compactor: on return every
        buffered row is flushed, the leveling policy is settled, and the
        manifest (if any) is committed.
        """
        self._check_open()
        if self.concurrent:
            self._compactor.drain(force=True)
            return
        if self._buf_count:
            self._flush(force=True)

    def checkpoint(self) -> None:
        """Request a durable manifest commit without stalling ingest.

        Synchronous mode: equivalent to ``flush()`` (inline flush+commit).
        Concurrent mode: marks the run set dirty and nudges the compactor,
        which commits (and rotates the WAL) as soon as current debt
        retires — the call returns immediately.  Acked inserts are already
        WAL-durable either way; a checkpoint only bounds replay length.
        """
        self._check_open()
        if not self.concurrent:
            self.flush()
            return
        with self._cv:
            if self.store is not None:
                self._dirty = True
            self._cv.notify_all()

    # ------------------------------------------------- flush/merge primitives
    def _take_head(self, force: bool = False) -> Optional[_PendingFlush]:
        """Detach the buffer head for flushing.  The head moves to
        ``_flushing`` so snapshots keep seeing it until the run publishes.
        Only references (and boundary views) change hands under the lock;
        the batch arrays are immutable once appended, so the expensive
        concatenation happens later, outside it."""
        with self._lock:
            if self._buf_count == 0:
                return None
            if not force and self._buf_count < self.buffer_capacity:
                return None
            take = self._buf_count if force else self.buffer_capacity
            head_raw, head_ts, head_ids = [], [], []
            head_fence, head_sum = [], []
            rest_raw, rest_ts, rest_ids = [], [], []
            rest_fence, rest_sum = [], []
            got = 0
            for raw, ts, ids, fence, summ in zip(
                    self._buf_raw, self._buf_ts, self._buf_ids,
                    self._buf_fence, self._buf_sum):
                need = take - got
                if need <= 0:
                    rest_raw.append(raw)
                    rest_ts.append(ts)
                    rest_ids.append(ids)
                    rest_fence.append(fence)
                    rest_sum.append(summ)
                elif len(raw) <= need:
                    head_raw.append(raw)
                    head_ts.append(ts)
                    head_ids.append(ids)
                    head_fence.append(fence)
                    head_sum.append(summ)
                    got += len(raw)
                else:                    # FIFO split inside one batch
                    head_raw.append(raw[:need])
                    head_ts.append(ts[:need])
                    head_ids.append(ids[:need])
                    rest_raw.append(raw[need:])
                    rest_ts.append(ts[need:])
                    rest_ids.append(ids[need:])
                    # both halves inherit the whole batch's fence — a
                    # superset range keeps the bound valid; summaries are
                    # row-wise, so they split exactly
                    head_fence.append(fence)
                    rest_fence.append(fence)
                    if summ is None:
                        head_sum.append(None)
                        rest_sum.append(None)
                    else:
                        head_sum.append((summ[0][:need], summ[1][:need]))
                        rest_sum.append((summ[0][need:], summ[1][need:]))
                    got = take
            self._buf_raw, self._buf_ts = rest_raw, rest_ts
            self._buf_ids, self._buf_fence = rest_ids, rest_fence
            self._buf_sum = rest_sum
            self._buf_count -= got
            entry = _PendingFlush(head_raw, head_ts, head_ids, got,
                                  fence=_combine_fences(head_fence),
                                  sum_parts=head_sum)
            self._flushing.append(entry)
            return entry

    def _build_run(self, entry: _PendingFlush) -> Run:
        t0 = time.perf_counter()
        with _span("compact.flush", rows=entry.n):
            head_raw = np.concatenate(entry.raw_parts)
            head_ts = np.concatenate(entry.ts_parts)
            head_ids = np.concatenate(entry.id_parts)
            paas = codes = None
            if entry.sum_parts and all(s is not None
                                       for s in entry.sum_parts):
                paas = _cat([s[0] for s in entry.sum_parts], self.device)
                codes = _cat([s[1] for s in entry.sum_parts], self.device)
            tree = T.build(head_raw, self.cfg, leaf_size=self.leaf_size,
                           materialized=self.materialized,
                           timestamps=head_ts, ids=head_ids, io=self.io,
                           paas=paas, codes=codes, device=self.device)
            _settle(self.device)
        reg = get_registry()
        reg.histogram("compact.flush_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        reg.histogram("compact.flush_rows").observe(entry.n)
        return Run(tree=tree, level=0,
                   t_min=int(head_ts.min()), t_max=int(head_ts.max()))

    def _merge_trees(self, a: Run, b: Run) -> T.CoconutTree:
        """Timed wrapper over ``tree.merge_trees`` shared by the inline
        (``_flush``) and background (``_bg_step``) merge sites."""
        t0 = time.perf_counter()
        with _span("compact.merge", rows=a.n + b.n,
                   level_a=a.level, level_b=b.level):
            merged = T.merge_trees(a.tree, b.tree, io=self.io)
            _settle(self.device)
        get_registry().histogram("compact.merge_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return merged

    def _publish_run(self, entry, run: Run) -> None:
        """Atomically swap the flushed head out of the buffer view and the
        new run into the list — a snapshot sees the rows exactly once."""
        with self._cv:
            self._flushing = [e for e in self._flushing if e is not entry]
            self.runs.insert(0, run)
            self.data_epoch += 1
            self._dirty = True
            self._cv.notify_all()

    def _merge_plan_locked(self) -> Optional[Tuple[Run, Run]]:
        """Next pair to merge under the leveling policy, or None.
        In ``pp`` mode, merge *everything* into one run (full index)."""
        if self.mode == "pp":
            if len(self.runs) > 1:
                return self.runs[-2], self.runs[-1]
            return None
        by_level: dict = {}
        for r in self.runs:
            by_level.setdefault(r.level, []).append(r)
        for _, rs in sorted(by_level.items()):
            if len(rs) >= self.size_ratio:
                return rs[0], rs[1]
        return None

    def _merge_plan(self) -> Optional[Tuple[Run, Run]]:
        with self._lock:
            return self._merge_plan_locked()

    def _apply_merge(self, a: Run, b: Run, merged: T.CoconutTree) -> None:
        """Swap runs ``a`` and ``b`` for their merge, keeping newest-first
        ordering by t_max.  The list is rebuilt and swapped in one step."""
        new = Run(tree=merged, level=max(a.level, b.level) + 1,
                  t_min=min(a.t_min, b.t_min), t_max=max(a.t_max, b.t_max))
        with self._cv:
            runs = [r for r in self.runs if r is not a and r is not b]
            pos = 0
            while pos < len(runs) and runs[pos].t_max > new.t_max:
                pos += 1
            runs.insert(pos, new)
            self.runs = runs
            self.merges += 1
            self.data_epoch += 1
            self._dirty = True
            self._cv.notify_all()

    def _flush(self, force: bool = False) -> None:
        """Synchronous flush: build + publish + full merge cascade + one
        atomic manifest commit."""
        entry = self._take_head(force)
        if entry is None:
            return
        self._publish_run(entry, self._build_run(entry))
        if self.mode != "tp":
            while (plan := self._merge_plan()) is not None:
                a, b = plan
                self._apply_merge(a, b, self._merge_trees(a, b))
        self._commit()      # one atomic manifest commit per flush

    # ------------------------------------------------ background-worker hooks
    def _bg_work_pending(self, force: bool) -> bool:
        """One unit of compaction debt outstanding?  (Engine lock held.)"""
        if self._buf_count >= self.buffer_capacity:
            return True
        if force and self._buf_count:
            return True
        if self._flushing:
            return True
        if self.mode != "tp" and self._merge_plan_locked() is not None:
            return True
        return self._dirty

    def _bg_step(self, force: bool = False) -> bool:
        """Retire one unit of debt: flush > merge > commit.  Expensive work
        (tree build, merge) runs outside the lock; only the buffer-head
        detach, the run-list swap, and the WAL rotation take it."""
        entry = self._take_head(force)
        if entry is not None:
            self._publish_run(entry, self._build_run(entry))
            self.ingest.add("bg_flushes")
            self._update_gauges()
            return True
        if self.mode != "tp":
            plan = self._merge_plan()
            if plan is not None:
                a, b = plan
                self._apply_merge(a, b, self._merge_trees(a, b))
                self.ingest.add("bg_merges")
                self._update_gauges()
                return True
        if self._dirty:
            self._commit()
            self._update_gauges()
            return True
        return False

    # ----------------------------------------------------------- backpressure
    def _lag_locked(self) -> int:
        return self._buf_count + sum(e.n for e in self._flushing)

    def _debt_locked(self) -> int:
        debt = (self._buf_count // self.buffer_capacity
                + len(self._flushing))
        if self.mode == "pp":
            debt += max(0, len(self.runs) - 1)
        elif self.mode == "btp":
            by_level: dict = {}
            for r in self.runs:
                by_level[r.level] = by_level.get(r.level, 0) + 1
            debt += sum(c // self.size_ratio for c in by_level.values())
        return debt

    def compaction_debt(self) -> int:
        """Outstanding flush+merge units (bounds ``insert`` backpressure)."""
        with self._lock:
            return self._debt_locked()

    def ingest_lag(self) -> int:
        """Rows acknowledged but not yet part of a published run."""
        with self._lock:
            return self._lag_locked()

    def _update_gauges(self) -> None:
        with self._lock:
            self.ingest.set_gauge("ingest_lag_rows", self._lag_locked())
            self.ingest.set_gauge("compaction_debt", self._debt_locked())

    # --------------------------------------------------------------- lifetime
    def close(self) -> None:
        """Deterministic shutdown: drain + stop the compactor thread and
        close the WAL handle.  Idempotent.  Rows still buffered without a
        store are dropped (in-memory engines are volatile by contract);
        with a store they remain in the WAL and replay on reopen."""
        if self._closed:
            return
        self._closed = True
        try:
            if self._compactor is not None:
                self._compactor.stop(drain=True)
        finally:
            if self.wal is not None:
                self.wal.close()

    def __enter__(self) -> "CoconutLSM":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------------- read
    @property
    def n(self) -> int:
        with self._lock:
            return (sum(r.n for r in self.runs) + self._buf_count
                    + sum(e.n for e in self._flushing))

    def snapshot(self, *, include_buffer: Optional[bool] = None):
        """Immutable point-in-time read view (see
        :class:`repro_torch.ingest.snapshot.Snapshot`).

        ``include_buffer`` defaults to the engine's concurrency mode: the
        synchronous engine keeps unflushed rows invisible until
        ``flush()``, the concurrent engine folds a frozen copy of the
        buffer in so answers never depend on how far the background
        compactor has gotten.
        """
        from ..ingest.snapshot import FrozenBuffer, Snapshot
        if include_buffer is None:
            include_buffer = self.concurrent
        with stage(None, "snapshot") as sp:
            parts = None
            part_fences = []
            with self._lock:                 # reference capture only, no copy
                runs = tuple(self.runs)
                clock = self.clock
                epoch = self.data_epoch
                if include_buffer:
                    parts = []
                    for e in self._flushing:
                        parts.extend(zip(e.raw_parts, e.ts_parts, e.id_parts))
                        part_fences.append(e.fence)
                    parts.extend(zip(self._buf_raw, self._buf_ts,
                                     self._buf_ids))
                    part_fences.extend(self._buf_fence)
            buf = None
            if include_buffer:               # batch arrays are immutable —
                if parts:                    # concatenate outside the lock
                    raw = np.concatenate([p[0] for p in parts])
                    ts = np.concatenate([p[1] for p in parts])
                    ids = np.concatenate([p[2] for p in parts])
                else:
                    raw = np.zeros((0, self.cfg.series_len), np.float32)
                    ts = np.zeros(0, np.int64)
                    ids = np.zeros(0, np.int64)
                buf = FrozenBuffer(raw=raw, ts=ts, ids=ids)
            # key fence over everything the snapshot can see: run fences are
            # exact (sorted trees); buffer batches contribute the fence their
            # insert declared, None poisoning the range to "unknown"
            fences = [r.key_fence for r in runs if r.n]
            if buf is not None and buf.n:
                fences.extend(part_fences)
            fence = _combine_fences(fences) if fences else None
            snap = Snapshot(runs=runs, clock=clock, mode=self.mode,
                            io=self.io, buffer=buf, key_fence=fence,
                            cfg=self.cfg, tiers=self.tiers, epoch=epoch,
                            scope=(self.store.root
                                   if self.store is not None else None),
                            device=self.device)
            sp.set(runs=len(runs), buffer_rows=0 if buf is None else buf.n)
        return snap

    def search_approx(self, query, *, k: int = 1,
                      window: Optional[int] = None,
                      radius_leaves: int = 1, budget=None
                      ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Approximate k-NN over a consistent snapshot (Algorithm-4 seed
        probes; ``budget`` buys extra frontier leaves and tightens the
        reported gap).  Returns (dists ``[k]``, ids ``[k]``, info)."""
        return self.snapshot().search_approx(
            query, k=k, window=window, radius_leaves=radius_leaves,
            budget=budget)

    def search_exact(self, query, *, k: int = 1,
                     window: Optional[int] = None,
                     radius_leaves: int = 1,
                     bsf: Optional[float] = None,
                     budget=None, mode: str = "exact"
                     ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Exact k-NN over a consistent snapshot through the unified
        pipeline (plan -> prune -> scan -> verify), with timestamp
        post-filtering in ``pp`` mode.  ``bsf`` seeds the chain with an
        external bound.  ``budget``/``mode="approx"`` switch to the
        budgeted frontier drain with a certified gap report.  Returns
        (dists ``[k]``, ids ``[k]``, info)."""
        return self.snapshot().search_exact(
            query, k=k, window=window, radius_leaves=radius_leaves,
            bsf=bsf, budget=budget, mode=mode)

    def search_approx_batch(self, queries, *, k: int = 1,
                            window: Optional[int] = None,
                            radius_leaves: int = 1, budget=None
                            ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Batched approximate k-NN: one probe per run serves all Q
        queries.  With k=1, row qi equals ``search_approx(queries[qi])``."""
        return self.snapshot().search_approx_batch(
            queries, k=k, window=window, radius_leaves=radius_leaves,
            budget=budget)

    def search_exact_batch(self, queries, *, k: int = 1,
                           window: Optional[int] = None,
                           radius_leaves: int = 1,
                           bsf: Optional[np.ndarray] = None,
                           budget=None, mode: str = "exact"
                           ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Batched exact k-NN: ONE amortized SIMS scan per qualifying run
        for the whole batch, per-query bounds carried run to run, cross-run
        top-k merge.  With k=1, row qi equals ``search_exact(queries[qi])``.
        ``bsf``: optional ``[Q]`` external per-query bounds.
        ``budget``/``mode="approx"``: budgeted frontier drain + gap report."""
        return self.snapshot().search_exact_batch(
            queries, k=k, window=window, radius_leaves=radius_leaves,
            bsf=bsf, budget=budget, mode=mode)

    # ------------------------------------------------------- sharding hooks
    def advance_clock(self, t: int) -> None:
        """Raise the logical clock to at least ``t`` (never lowers it), so
        window queries cut at the same instant on every shard."""
        with self._lock:
            if t > self.clock:
                self.clock = t

    def max_id(self) -> int:
        """Highest global row id anywhere in the engine (-1 when empty)."""
        with self._lock:
            runs = list(self.runs)
            parts = [ids for e in self._flushing for ids in e.id_parts]
            parts.extend(self._buf_ids)
        m = -1
        for r in runs:
            if r.tree.ids is not None and r.n:
                m = max(m, int(r.tree.ids.max()))
        for a in parts:
            if len(a):
                m = max(m, int(a.max()))
        return m

    @property
    def rows_inserted(self) -> int:
        """Rows ever accepted by this engine (its local insert stream)."""
        with self._lock:
            return self._rows_inserted

    # ------------------------------------------------------------ diagnostics
    def level_histogram(self) -> dict:
        hist = {}
        with self._lock:
            for r in self.runs:
                hist[r.level] = hist.get(r.level, 0) + 1
        return hist

    def check_invariants(self) -> None:
        """Ratio-2 leveling invariant: at most one run per level (btp/pp).
        Only meaningful when compaction has settled (after ``flush()``)."""
        if self.mode == "tp":
            return
        hist = self.level_histogram()
        for level, cnt in hist.items():
            assert cnt < self.size_ratio + 1, \
                f"level {level} has {cnt} runs (ratio {self.size_ratio})"


# ---------------------------------------------------------------------------
# Carrying an engine across: numpy state <-> CoconutLSM
# ---------------------------------------------------------------------------

_SETTINGS = ("buffer_capacity", "leaf_size", "size_ratio", "mode",
             "materialized")


def to_numpy(engine: CoconutLSM) -> Dict[str, object]:
    """An engine's whole state as numpy arrays and plain values:

    * ``cfg`` (``series_len``, ``segments``, ``bits``) and the settings
      ``buffer_capacity``, ``leaf_size``, ``size_ratio``, ``mode``,
      ``materialized``;
    * ``clock``, ``merges``, ``rows_inserted``;
    * ``runs``, newest first: each a dict of ``level``, ``t_min``,
      ``t_max`` and ``columns`` (the tree's columns as
      :func:`repro_torch.core.tree.to_numpy` gives them);
    * ``buffer``: the not-yet-flushed parts in insertion order, each a
      dict of ``raw``, ``ts`` and ``ids``.

    Take it with compaction settled (a synchronous engine, or after
    ``flush()``)."""
    with engine._lock:
        runs = list(engine.runs)
        parts = []
        for e in engine._flushing:
            parts.extend(zip(e.raw_parts, e.ts_parts, e.id_parts))
        parts.extend(zip(engine._buf_raw, engine._buf_ts, engine._buf_ids))
        state = {"cfg": {"series_len": engine.cfg.series_len,
                         "segments": engine.cfg.segments,
                         "bits": engine.cfg.bits},
                 "clock": engine.clock, "merges": engine.merges,
                 "rows_inserted": engine._rows_inserted}
        for name in _SETTINGS:
            state[name] = getattr(engine, name)
    state["runs"] = [{"level": r.level, "t_min": r.t_min, "t_max": r.t_max,
                      "columns": T.to_numpy(r.tree)} for r in runs]
    state["buffer"] = [{"raw": np.array(raw), "ts": np.array(ts, np.int64),
                        "ids": np.array(ids, np.int64)}
                       for raw, ts, ids in parts]
    return state


def from_numpy(state: Dict[str, object], *, device=None,
               concurrent: bool = False, max_debt: int = 4,
               io: Optional[IOStats] = None) -> CoconutLSM:
    """An engine from the state :func:`to_numpy` gives (or one made from a
    reference engine the same way): its runs' trees go to ``device`` (the
    card by default), its buffer stays on the host.  Searches and later
    inserts then behave as on the engine the state came from."""
    c = state["cfg"]
    cfg = S.SummaryConfig(c["series_len"], c["segments"], c["bits"])
    eng = CoconutLSM(cfg, **{name: state[name] for name in _SETTINGS},
                     io=io, device=device)
    eng.clock = int(state["clock"])
    eng.merges = int(state["merges"])
    eng._rows_inserted = int(state["rows_inserted"])
    for r in state["runs"]:
        tree = T.from_numpy(r["columns"], series_len=cfg.series_len,
                            segments=cfg.segments, bits=cfg.bits,
                            leaf_size=eng.leaf_size, device=eng.device)
        eng.runs.append(Run(tree=tree, level=int(r["level"]),
                            t_min=int(r["t_min"]), t_max=int(r["t_max"])))
    for p in state["buffer"]:
        raw = np.asarray(p["raw"], np.float32)
        eng._buf_raw.append(raw)
        eng._buf_ts.append(np.asarray(p["ts"], np.int64))
        eng._buf_ids.append(np.asarray(p["ids"], np.int64))
        eng._buf_fence.append(None)
        eng._buf_sum.append(None)
        eng._buf_count += len(raw)
    if concurrent:
        from ..ingest.compactor import Compactor
        eng.concurrent = True
        eng.max_debt = max_debt
        eng._compactor = Compactor(eng)
    return eng
