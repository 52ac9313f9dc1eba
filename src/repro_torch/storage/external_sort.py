"""External-sort bulk load (paper Algorithm 3) with real spill files.

The in-memory ``tree.build`` assumes the whole dataset fits on the device.
This module is the paper's actual construction story: summarize and sort
fixed-size chunks on the device, spill each sorted chunk to disk as a
segment file (one large sequential write), then merge the sorted spills
into ONE contiguous output segment (sequential reads in, one sequential
write out) — O(N/B) block transfers end to end, for datasets bounded by
disk rather than device or host memory.

Pass 1 runs the reference's two construction stages on the device, the
``sax_summarize`` then the ``zorder`` kernel (their plain twins on the
CPU), then a stable ``lexsort_keys``.  The in-memory build keeps the fused
``fused_build`` kernel; the two routes are written independently and give
the same columns, which the tests and ``chip_smoke.py`` hold.

Pass 2 merges in batches rather than row by row.  It holds the next
batch of keys of every spill and emits every held row that precedes, in
the merge order (key, spill, row), all rows not yet read: the rows below
the least (last held key, spill) pair over the spills with unread rows (a
prefix of each spill's batch).  It orders those rows by a stable sort on
the key words — they arrive in (spill, row) order, so ties keep that
order — and appends them to the output ``merge_batch`` rows at a time.

Stability contract: chunks are processed in input order, each chunk is
sorted stably, and equal keys merge by (chunk index, row-within-chunk).
The resulting order is therefore *identical* to a stable in-memory sort of
the full input, and to the reference package's row-by-row heap merge.
"""
from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Union

import numpy as np
import torch

from ..core import keys as K
from ..core import summarization as S
from ..core.metrics import IOStats
from ..kernels import ops
from .segment import Segment, SegmentWriter

__all__ = ["build_external"]

Chunks = Union[np.ndarray, torch.Tensor, Iterable[np.ndarray]]


def _iter_chunks(raw: Chunks, chunk_size: int) -> Iterator[np.ndarray]:
    if hasattr(raw, "shape") and hasattr(raw, "__getitem__"):
        for s in range(0, int(raw.shape[0]), chunk_size):
            c = raw[s: s + chunk_size]
            if isinstance(c, torch.Tensor):
                c = c.detach().cpu().numpy()
            yield np.asarray(c, np.float32)
    else:
        for c in raw:
            if isinstance(c, torch.Tensor):
                c = c.detach().cpu().numpy()
            yield np.asarray(c, np.float32)


def _sorted_chunk(raw_c: np.ndarray, cfg: S.SummaryConfig, znorm: bool,
                  dev: torch.device):
    """Summarize + stable-sort one chunk on ``dev``; host columns in key
    order (uint32 key words, as on disk)."""
    x = torch.from_numpy(raw_c).to(dev)
    if znorm:
        x = S.znormalize(x)
    paas, codes = ops.sax_summarize(x, cfg)
    keys = ops.zorder(codes, cfg)
    order = K.lexsort_keys(keys)
    return (keys[order].cpu().numpy().astype(np.uint32),
            codes[order].cpu().numpy(), paas[order].cpu().numpy(),
            order.cpu().numpy(), x[order].cpu().numpy())


def _merge(spills: List[Segment], out: SegmentWriter, batch: int,
           has_ts: bool, io: Optional[IOStats]) -> None:
    """Batched k-way merge of sorted spills into ``out`` (module doc).

    Each spill is read in aligned batches of ``batch`` rows, each charged
    to ``io`` as one sequential read of all its columns when its keys are
    first needed, and the output is appended ``batch`` rows at a time —
    the same charges as the reference's row-by-row merge."""
    names = ("codes", "paas", "offsets", "ts", "raw")
    n_words = out.cfg.n_words
    loaded = [0] * len(spills)             # rows whose keys are in heads
    pos = [0] * len(spills)                # rows emitted
    heads = [np.zeros((0, n_words), np.uint32) for _ in spills]
    pending = None

    def emit(cols, final=False):
        nonlocal pending
        if pending is not None:
            cols = {k: None if v is None else np.concatenate([pending[k], v])
                    for k, v in cols.items()}
        n = len(cols["keys"])
        stop = n if final else n - n % batch
        for s in range(0, stop, batch):
            out.append(*(cols[k][s:s + batch] for k in ("keys", "codes",
                                                         "paas", "offsets")),
                       timestamps=(cols["ts"][s:s + batch] if has_ts
                                   else None),
                       raw=cols["raw"][s:s + batch])
        pending = {k: None if v is None else v[stop:]
                   for k, v in cols.items()}

    while any(p < seg.n for p, seg in zip(pos, spills)):
        for si, seg in enumerate(spills):
            if len(heads[si]) < batch and loaded[si] < seg.n:
                s, e = loaded[si], min(loaded[si] + batch, seg.n)
                heads[si] = np.concatenate(
                    [heads[si], np.asarray(seg.keys[s:e])])
                loaded[si] = e
                if io is not None:
                    row = (seg.code_row_bytes + 4 * (seg.cfg.segments
                                                     + n_words)
                           + 8 + (8 if has_ts else 0)
                           + 4 * seg.cfg.series_len)
                    io.read_bytes((e - s) * row)
                    io.seq_read(e - s)
        # the merge order is (key, spill, row).  Every unread row of spill
        # b comes after (last key of b's head, b), so every loaded row
        # before the least such pair (thr, tb) can be emitted: keys below
        # thr, and keys equal to thr from spills up to tb (tb's whole head)
        bounded = [si for si, seg in enumerate(spills)
                   if loaded[si] < seg.n]
        thr = tb = None
        if bounded:
            lasts = np.stack([heads[si][-1] for si in bounded])
            tb = bounded[int(K.lexsort_keys_np(lasts)[0])]  # stable: least b
            thr = heads[tb][-1]
        parts = {k: [] for k in ("keys",) + names}
        for si, seg in enumerate(spills):
            head = heads[si]
            c = (len(head) if thr is None
                 else K.count_below_np(head, thr, inclusive=si <= tb))
            if not c:
                continue
            s = pos[si]
            parts["keys"].append(head[:c])
            for name, col in zip(names, (seg.columns["codes"], seg.paas,
                                         seg.offsets, seg.timestamps,
                                         seg.raw)):
                if col is not None:
                    parts[name].append(np.array(col[s:s + c]))
            pos[si] = s + c
            heads[si] = head[c:]
        order = K.lexsort_keys_np(np.concatenate(parts["keys"]))
        emit({k: np.concatenate(v)[order] if v else None
              for k, v in parts.items()})
    if pending is not None and len(pending["keys"]):
        emit({k: None if v is None else v[:0] for k, v in pending.items()},
             final=True)


def build_external(raw: Chunks, cfg: S.SummaryConfig, *,
                   workdir: str,
                   chunk_size: int = 65536,
                   leaf_size: int = 256,
                   timestamps: Optional[np.ndarray] = None,
                   znorm: bool = False,
                   out_path: Optional[str] = None,
                   merge_batch: int = 4096,
                   keep_spills: bool = False,
                   io: Optional[IOStats] = None,
                   device=None,
                   times: Optional[dict] = None) -> Segment:
    """Bulk-load one on-disk segment from data larger than device memory.

    ``raw`` is an array or tensor ``[N, L]`` or an iterable of ``[m, L]``
    chunks (the larger-than-memory path; one chunk is resident at a time).
    The chunks are summarized and sorted on ``device`` (the card unless
    ``device="cpu"``).  ``merge_batch``: rows read from each spill per
    merge round.  ``times``: when given, receives the two passes' seconds
    under ``"pass1"`` and ``"pass2"``.  Returns the opened output
    :class:`Segment`; load it with ``.to_tree()`` or query it in place
    with :func:`repro_torch.storage.segment.exact_search_mmap`.

    Only the materialized (Coconut-Tree-Full) layout is supported: the
    merge streams raw rows into their sorted position.
    """
    import time

    from ..core.tree import _device_for
    if timestamps is not None and not hasattr(raw, "shape"):
        raise ValueError("timestamps require array (not iterator) input")
    dev = _device_for(raw if isinstance(raw, torch.Tensor) else None, device)
    os.makedirs(workdir, exist_ok=True)
    out_path = out_path or os.path.join(workdir, "external.coco")
    has_ts = timestamps is not None

    # -- pass 1: summarize + sort fixed-size chunks, spill each to disk -----
    t0 = time.perf_counter()
    spill_paths = []
    start = 0
    try:
        for ci, raw_c in enumerate(_iter_chunks(raw, chunk_size)):
            m = raw_c.shape[0]
            keys, codes, paas, order, raw_sorted = _sorted_chunk(
                raw_c, cfg, znorm, dev)
            path = os.path.join(workdir, f"spill-{ci:04d}.coco")
            w = SegmentWriter(path, cfg, m, leaf_size=leaf_size,
                              materialized=True, has_timestamps=has_ts,
                              has_raw=True, io=io)
            spill_paths.append(path)
            try:
                ts_c = (np.asarray(timestamps[start: start + m])[order]
                        if has_ts else None)
                w.append(keys, codes, paas, (start + order).astype(np.int64),
                         timestamps=ts_c, raw=raw_sorted)
                w.finalize()
            except BaseException:
                w.abort()
                raise
            start += m
        t1 = time.perf_counter()

        # -- pass 2: merge the sorted spills into ONE contiguous segment ----
        spills = [Segment.open(p) for p in spill_paths]
        out = SegmentWriter(out_path, cfg, start, leaf_size=leaf_size,
                            materialized=True, has_timestamps=has_ts,
                            has_raw=True, io=io)
        try:
            _merge(spills, out, merge_batch, has_ts, io)
            out.finalize()
        except BaseException:
            out.abort()
            raise
        finally:
            for seg in spills:
                seg.close()
    finally:
        if not keep_spills:
            for p in spill_paths:
                if os.path.exists(p):
                    os.unlink(p)
    if times is not None:
        times["pass1"] = t1 - t0
        times["pass2"] = time.perf_counter() - t1
    return Segment.open(out_path)
