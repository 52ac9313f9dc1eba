"""The uniform partition view every search source exposes to the planner.

A :class:`Partition` is one searchable unit, normalized to what the
pipeline needs: ``(keys, codes, leaf_fences, ts_range, backend)``.  There
are three kinds:

* ``tree`` (backend ``"device"``) — a sorted Coconut run held on a device
  (:class:`repro_torch.core.tree.CoconutTree`); row accessors gather the
  surviving leaves on the tree's device;
* ``segment`` (backend ``"mmap"``) — a sorted run on disk
  (:class:`repro_torch.storage.segment.Segment`): rows are read on the
  host from the mmap, charged to ``io`` as real ``bytes_read``, and copied
  to the partition's device, where its kernels run (the card unless
  ``device="cpu"``);
* ``buffer`` (backend ``"host"``) — an unsorted frozen insert buffer
  (:class:`repro_torch.ingest.snapshot.FrozenBuffer`): its rows stay on
  the host, as the reference's do, and the executor copies them to the
  partition's device per scan and brute-forces them.

Sorted partitions answer *leaf-granular* questions: the leaf-first z-order
keys (fence pointers) from which the planner derives per-leaf mindist
bounds, and row-subset accessors (``codes_rows`` / ``series_rows``) that
fetch only the surviving leaves.

Segment partitions optionally carry a
:class:`repro_torch.storage.tiers.TieredLeafStore`: row gathers then
assemble from leaf-granular cached blocks (host-RAM warm tier, device hot
tier) and fall through to the mmap only on a miss.  Byte accounting keeps
two strict currencies: a miss charges the *stored* (packed) bytes to
``io.bytes_read``; a hit charges nothing to ``io`` and credits the same
figure to ``cache.bytes_saved``.  Answers are bit-identical across tiers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import keys as K
from ..core import summarization as S
from ..core.metrics import IOStats

__all__ = ["Partition"]


def _rows(col, idx):
    """``col[idx]`` for host row numbers: a view when they are one
    ascending run (a leaf group of consecutive leaves), else a gather
    (numpy for a host array, torch on the column's device for a tensor)."""
    idx = np.asarray(idx)
    if len(idx) and (len(idx) == 1 or bool(np.all(np.diff(idx) == 1))):
        return col[int(idx[0]):int(idx[-1]) + 1]
    if isinstance(col, np.ndarray):
        return col[idx]
    return col[torch.as_tensor(idx, dtype=torch.int64, device=col.device)]


def _on(a, dev: torch.device) -> torch.Tensor:
    """A host array (fresh and writable) or a tensor, on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@dataclasses.dataclass
class Partition:
    """One searchable unit behind the planner/executor pipeline."""
    kind: str                 # "tree" | "segment" | "buffer"
    backend: str              # "device" | "mmap" | "host"
    cfg: S.SummaryConfig
    n: int
    leaf_size: int
    source: object
    ts_range: Optional[Tuple[int, int]] = None   # (t_min, t_max) or None
    tiers: Optional[object] = None               # TieredLeafStore or None
    scan_device: Optional[torch.device] = None   # segment/buffer: kernels' device

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_tree(cls, tree, *, ts_range: Optional[Tuple[int, int]] = None
                  ) -> "Partition":
        """Wrap a ``CoconutTree`` held on a device (CUDA or CPU)."""
        return cls(kind="tree", backend="device", cfg=tree.cfg,
                   n=tree.n, leaf_size=tree.leaf_size, source=tree,
                   ts_range=ts_range)

    @classmethod
    def from_run(cls, run) -> "Partition":
        """Wrap one LSM :class:`~repro_torch.core.lsm.Run` (tree + time
        range)."""
        return cls.from_tree(run.tree, ts_range=(run.t_min, run.t_max))

    @classmethod
    def from_segment(cls, seg, *,
                     ts_range: Optional[Tuple[int, int]] = None,
                     tiers: Optional[object] = None,
                     device=None) -> "Partition":
        """Wrap an on-disk :class:`~repro_torch.storage.segment.Segment`;
        all row access goes through the mmap and is charged to ``io``.
        ``ts_range`` is optional (computing it would read the whole
        timestamp column).  ``tiers`` attaches a
        :class:`~repro_torch.storage.tiers.TieredLeafStore` so leaf blocks
        are served from cache when warm.  ``device``: where the kernels
        run — the card unless ``device="cpu"``; without CUDA and no
        explicit CPU request this raises."""
        from ..core.tree import _device_for
        return cls(kind="segment", backend="mmap", cfg=seg.cfg,
                   n=seg.n, leaf_size=seg.leaf_size, source=seg,
                   ts_range=ts_range, tiers=tiers,
                   scan_device=_device_for(None, device))

    @classmethod
    def from_buffer(cls, buf, cfg: S.SummaryConfig, *,
                    ts_range: Optional[Tuple[int, int]] = None,
                    device=None) -> "Partition":
        """Wrap a frozen (unsorted) insert buffer — brute-force scanned on
        ``device`` (the card unless ``device="cpu"``; without CUDA and no
        explicit CPU request this raises)."""
        from ..core.tree import _device_for
        return cls(kind="buffer", backend="host", cfg=cfg,
                   n=buf.n, leaf_size=max(1, buf.n), source=buf,
                   ts_range=ts_range, scan_device=_device_for(None, device))

    # -------------------------------------------------------------- properties
    @property
    def is_sorted(self) -> bool:
        return self.kind != "buffer"

    @property
    def n_leaves(self) -> int:
        return -(-self.n // self.leaf_size)

    @property
    def device(self) -> torch.device:
        """Where the partition's kernels run (a tree's: where it lives)."""
        if self.kind == "tree":
            return self.source.keys.device
        return self.scan_device

    @property
    def cache_token(self):
        """Cache group key for this partition's leaf blocks: the segment
        path.  Segment files are immutable once published and their ids
        are never reused, so the path identifies the bytes forever."""
        return getattr(self.source, "path", None)

    @property
    def is_packed(self) -> bool:
        """True when the source stores bit-packed v3 code rows — the
        executor's cue that the ``unpack_mindist`` path applies."""
        return (self.kind == "segment"
                and getattr(self.source, "codes_packed", None) is not None)

    @property
    def code_row_bytes(self) -> int:
        """Stored bytes per code row — what one row costs to read."""
        if self.kind == "segment":
            return self.source.code_row_bytes
        return self.cfg.segments

    # ----------------------------------------------------------- sorted access
    def leaf_fences(self, io: Optional[IOStats] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(leaf-first keys ``[n_leaves, n_words]`` uint32, last key
        ``[n_words]``) — the implicit internal-node layer the planner
        turns into per-leaf code envelopes."""
        if self.kind == "tree":
            fences = self.source.fences.cpu().numpy().astype(np.uint32)
            last = self.source.keys[-1].cpu().numpy().astype(np.uint32)
            return fences, last
        fences = np.asarray(self.source.fences)
        last = np.asarray(self.source.keys[self.n - 1])
        if io is not None:
            io.read_bytes(fences.nbytes + last.nbytes)
        return fences, last

    def seed_window(self, queries: torch.Tensor, *, radius_leaves: int = 1,
                    io: Optional[IOStats] = None):
        """Row indices ``[Q, span]`` of the rows around each query's
        z-order insertion point — the Algorithm-4 probe that seeds the
        exact scan's best-so-far pool (``queries`` on :attr:`device`).

        Both kinds resolve the *row-granular* insertion point: the tree
        by binary search over its device key column (a tensor on the
        tree's device comes back), the segment by a fence search refined
        inside ONE leaf of the mmap'd key column (a host array comes
        back), so the windows are identical across kinds.  The query keys
        are the ``sax_summarize`` + ``zorder`` kernels' on the card."""
        if self.kind == "tree":
            from ..core.tree import _seed_index
            idx = _seed_index(self.source, queries,
                              radius_leaves=radius_leaves)
        else:
            idx = self._segment_window(queries, radius_leaves, io)
        if io is not None:
            io.rand_read(2 * radius_leaves * len(idx))
        return idx

    def _segment_window(self, queries: torch.Tensor, radius_leaves: int,
                        io: Optional[IOStats]) -> np.ndarray:
        from ..kernels import ops
        cfg = self.cfg
        nq = queries.shape[0]
        _, q_codes = ops.sax_summarize(queries, cfg)
        q_keys = ops.zorder(q_codes, cfg).cpu().numpy()         # [Q, nw]
        # fence bytes were already charged when the planner read the fence
        # column for the leaf envelopes; the probe rereads the same (now
        # hot) pages, so it is not charged again
        fences = np.asarray(self.source.fences).astype(np.int64)
        fl = (K.searchsorted_keys(torch.from_numpy(fences),
                                  torch.from_numpy(q_keys)).numpy()
              if len(fences) else np.zeros(nq, np.int64))
        # the row insertion point lies in the leaf just before the first
        # fence >= the query key (everything earlier is strictly below
        # it), so one leaf of the key column per query resolves it exactly
        pos = np.zeros(nq, np.int64)
        for qi in range(nq):
            if int(fl[qi]) == 0:
                continue                       # keys[0] >= q_key: pos 0
            li = int(fl[qi]) - 1
            blk = np.asarray(self._leaf_block("keys", li, io), np.int64)
            pos[qi] = li * self.leaf_size + K.count_below_np(blk, q_keys[qi])
        span = 2 * radius_leaves * self.leaf_size
        start = np.clip(pos - span // 2, 0, max(self.n - span, 0))
        idx = start[:, None] + np.arange(span)[None, :]
        return np.clip(idx, 0, self.n - 1)

    # ------------------------------------------------------------- leaf tiers
    def _leaf_block(self, col: str, li: int, io: Optional[IOStats] = None):
        """One leaf of the ``codes`` (stored form: packed on v3) or
        ``keys`` (decoded uint32) column, through the tier cache when
        attached.

        A hit returns the cached block (a device tensor for hot code
        leaves) with no ``io`` charge — the tier store credits the stored
        bytes to ``cache.bytes_saved`` instead.  A miss reads the mmap,
        charges the stored bytes to ``io.bytes_read``, and admits the
        block to the warm tier.
        """
        seg = self.source
        s = li * self.leaf_size
        e = min(s + self.leaf_size, self.n)
        if col == "codes":
            stored = (e - s) * self.code_row_bytes
        else:
            stored = seg.keys_leaf_nbytes(li)
        if self.tiers is not None:
            blk = self.tiers.get(self.cache_token, col, li, stored,
                                 device=self.device)
            if blk is not None:
                return blk
        if col == "codes":
            src = seg.codes_packed
            blk = np.array((seg.codes if src is None else src)[s:e])
        else:
            blk = np.asarray(seg.keys[s:e])
        if io is not None:
            io.read_bytes(stored)
            if col == "codes":
                io.seq_read(e - s)
        if self.tiers is not None:
            self.tiers.admit(self.cache_token, col, li, blk, stored)
        return blk

    def _gather_rows(self, col: str, idx: np.ndarray,
                     io: Optional[IOStats] = None):
        """Stored-form rows for sorted indices, assembled leaf by leaf
        through the cache.  Stays on the device (``torch.cat``) when every
        touched block is device-resident: the hot tier then feeds the
        bound kernel with no host-to-device copy."""
        idx = np.asarray(idx)
        leaves = idx // self.leaf_size
        parts, device = [], True
        for li in np.unique(leaves):           # sorted, like idx
            blk = self._leaf_block(col, int(li), io)
            local = idx[leaves == li] - int(li) * self.leaf_size
            if not isinstance(blk, torch.Tensor):
                device = False
            parts.append(_rows(blk, local))
        if len(parts) == 1:
            return parts[0]
        if device:
            return torch.cat(parts)
        return np.concatenate([p.cpu().numpy() if isinstance(p, torch.Tensor)
                               else p for p in parts])

    def codes_rows(self, idx, io: Optional[IOStats] = None) -> torch.Tensor:
        """Full-width SAX code rows for sorted-order indices, on
        :attr:`device` (segment reads charged at the stored width)."""
        if self.kind == "tree":
            return _rows(self.source.codes, idx)
        if self.tiers is not None:
            blk = self._gather_rows("codes", idx, io)
            if self.is_packed:
                from ..storage.packing import unpack_codes
                if isinstance(blk, torch.Tensor):
                    blk = blk.cpu().numpy()
                blk = unpack_codes(blk, self.cfg.segments, self.cfg.bits)
            return _on(blk, self.device)
        blk = np.asarray(self.source.codes[np.asarray(idx)])
        if io is not None:
            io.read_bytes(len(blk) * self.code_row_bytes)
            io.seq_read(len(blk))
        return _on(blk, self.device)

    def codes_rows_packed(self, idx, io: Optional[IOStats] = None
                          ) -> torch.Tensor:
        """Packed (stored-form) code rows on :attr:`device` — the
        ``unpack_mindist`` kernel's input.  Only meaningful when
        :attr:`is_packed`; hot blocks are already there."""
        if self.tiers is not None:
            return _on(self._gather_rows("codes", idx, io), self.device)
        from ..storage.segment import take_rows
        blk = take_rows(self.source.codes_packed, idx)
        if io is not None:
            io.read_bytes(blk.nbytes)
            io.seq_read(len(blk))
        return _on(blk, self.device)

    def series_rows(self, idx, io: Optional[IOStats] = None) -> torch.Tensor:
        """Raw rows for sorted-order indices (verification fetch), on
        :attr:`device`."""
        if self.kind == "segment":
            return _on(self.source.series_rows(idx, io=io), self.device)
        src = self.source
        if src.raw is not None:
            return _rows(src.raw, idx)
        return src.series(torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                                          device=self.device))

    def seed_distances(self, queries: torch.Tensor, idx,
                       io: Optional[IOStats] = None) -> torch.Tensor:
        """Squared ED ``[Q, C]`` of each query to its seed rows ``idx``
        ``[Q, C]``, through the gathered ED kernel.  A tree's kernel reads
        its raw column by index (no ``[Q, C, L]`` copy); a segment's rows
        are read off the mmap, one query's window at a time, into one
        device block the kernel then reads by index."""
        from ..kernels import ops
        if self.kind == "tree":
            base, rows = self.source.series_source(idx)
            return ops.batch_euclid_multi(queries, base, idx=rows)
        nq, c = idx.shape
        base = torch.empty((nq * c, self.cfg.series_len),
                           dtype=torch.float32, device=self.device)
        for qi in range(nq):
            base[qi * c:(qi + 1) * c] = _on(
                self.source.series_rows(idx[qi], io=io), self.device)
        rows = torch.arange(nq * c, device=self.device).reshape(nq, c)
        return ops.batch_euclid_multi(queries, base, idx=rows)

    # ------------------------------------------------------------- row columns
    def report_ids(self) -> np.ndarray:
        """Column reported as the 'offset' of an answer: the global row
        id when the partition carries ids, else the position in the
        original raw file (a segment's columns stay memmapped)."""
        if self.kind == "buffer":
            return np.asarray(self.source.ids)
        if self.kind == "segment":
            src = self.source
            return np.asarray(src.ids if src.ids is not None
                              else src.offsets)
        return self._host_column("ids" if self.source.ids is not None
                                 else "offsets").astype(np.int64, copy=False)

    def timestamps(self) -> Optional[np.ndarray]:
        if self.kind == "buffer":
            return np.asarray(self.source.ts)
        if self.source.timestamps is None:
            return None
        if self.kind == "segment":
            return np.asarray(self.source.timestamps)
        return self._host_column("timestamps")

    def _host_column(self, name: str) -> np.ndarray:
        """Host copy of one of a tree's columns, made once per source:
        a built tree's columns never change, and on the card each copy
        crosses the bus."""
        src = self.source
        cache = src.__dict__.setdefault("_coconut_host_cols", {})
        if name not in cache:
            cache[name] = getattr(src, name).cpu().numpy()
        return cache[name]

    def buffer_raw(self) -> np.ndarray:
        """A buffer partition's rows, on the host in insertion order."""
        return np.asarray(self.source.raw)
