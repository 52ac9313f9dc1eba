"""The uniform partition view every search source exposes to the planner.

A :class:`Partition` is one searchable unit, normalized to what the
pipeline needs: ``(keys, codes, leaf_fences, ts_range)``.  This
slice of the port carries the ``tree`` kind: a sorted Coconut run held on a
device (:class:`repro_torch.core.tree.CoconutTree`).  Sorted partitions
answer *leaf-granular* questions: the leaf-first z-order keys (fence
pointers) from which the planner derives per-leaf mindist bounds, and
row-subset accessors (``codes_rows`` / ``series_rows``) that gather only
the surviving leaves on the tree's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import summarization as S
from ..core.metrics import IOStats

__all__ = ["Partition"]


def _rows(col: torch.Tensor, idx) -> torch.Tensor:
    """``col[idx]`` for host row numbers: a view when they are one
    ascending run (a leaf group of consecutive leaves), else a gather."""
    idx = np.asarray(idx)
    if len(idx) and (len(idx) == 1 or bool(np.all(np.diff(idx) == 1))):
        return col[int(idx[0]):int(idx[-1]) + 1]
    return col[torch.as_tensor(idx, dtype=torch.int64, device=col.device)]


@dataclasses.dataclass
class Partition:
    """One searchable unit behind the planner/executor pipeline."""
    kind: str                 # "tree"
    cfg: S.SummaryConfig
    n: int
    leaf_size: int
    source: object
    ts_range: Optional[Tuple[int, int]] = None   # (t_min, t_max) or None

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_tree(cls, tree, *, ts_range: Optional[Tuple[int, int]] = None
                  ) -> "Partition":
        """Wrap a ``CoconutTree`` held on a device (CUDA or CPU)."""
        return cls(kind="tree", cfg=tree.cfg,
                   n=tree.n, leaf_size=tree.leaf_size, source=tree,
                   ts_range=ts_range)

    # -------------------------------------------------------------- properties
    @property
    def n_leaves(self) -> int:
        return -(-self.n // self.leaf_size)

    @property
    def device(self) -> torch.device:
        """Where the partition's columns live (and its kernels run)."""
        return self.source.keys.device

    # ----------------------------------------------------------- sorted access
    def leaf_fences(self, io: Optional[IOStats] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(leaf-first keys ``[n_leaves, n_words]`` uint32, last key
        ``[n_words]``) — the implicit internal-node layer the planner
        turns into per-leaf code envelopes."""
        fences = self.source.fences.cpu().numpy().astype(np.uint32)
        last = self.source.keys[-1].cpu().numpy().astype(np.uint32)
        return fences, last

    def seed_window(self, queries: torch.Tensor, *, radius_leaves: int = 1,
                    io: Optional[IOStats] = None) -> torch.Tensor:
        """Row indices ``[Q, span]`` (on the partition's device) of the rows
        around each query's z-order insertion point — the Algorithm-4
        probe that seeds the exact scan's best-so-far pool."""
        from ..core.tree import _seed_index
        idx = _seed_index(self.source, queries, radius_leaves=radius_leaves)
        if io is not None:
            io.rand_read(2 * radius_leaves * len(idx))
        return idx

    def codes_rows(self, idx, io: Optional[IOStats] = None) -> torch.Tensor:
        """Full-width SAX code rows for sorted-order indices."""
        return _rows(self.source.codes, idx)

    def series_rows(self, idx, io: Optional[IOStats] = None) -> torch.Tensor:
        """Raw rows for sorted-order indices (verification fetch)."""
        src = self.source
        if src.raw is not None:
            return _rows(src.raw, idx)
        return src.series(torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                                          device=self.device))

    def seed_distances(self, queries: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
        """Squared ED ``[Q, C]`` of each query to its seed rows ``idx``
        ``[Q, C]``, through the gathered ED kernel (no ``[Q, C, L]``
        copy of the rows)."""
        from ..kernels import ops
        base, rows = self.source.series_source(idx)
        return ops.batch_euclid_multi(queries, base, idx=rows)

    # ------------------------------------------------------------- row columns
    def report_ids(self) -> np.ndarray:
        """Column reported as the 'offset' of an answer: the global row
        id when the partition carries ids, else the position in the
        original raw file."""
        return self._host_column("ids" if self.source.ids is not None
                                 else "offsets").astype(np.int64, copy=False)

    def timestamps(self) -> Optional[np.ndarray]:
        if self.source.timestamps is None:
            return None
        return self._host_column("timestamps")

    def _host_column(self, name: str) -> np.ndarray:
        """Host copy of one of the source's columns, made once per source:
        a built tree's columns never change, and on the card each copy
        crosses the bus."""
        src = self.source
        cache = src.__dict__.setdefault("_coconut_host_cols", {})
        if name not in cache:
            cache[name] = getattr(src, name).cpu().numpy()
        return cache[name]
