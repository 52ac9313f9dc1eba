"""Coconut-Tree: bottom-up bulk-loaded, median-split, contiguous index.

Paper Sec. 4.3.  The index is a *sorted array* of (invSAX key, offset[, raw])
plus fence pointers — the static equivalent of a bulk-loaded UB-tree.  Because
the data is totally ordered by the z-order key:

* construction = summarize + sort (the external sort of Algorithm 3),
* every "leaf" (block of ``leaf_size`` consecutive entries) is 100% full
  except the last — median splitting taken to its limit,
* approximate search = binary search + a radius of adjacent leaves
  (Algorithm 4),
* exact search = SIMS (Algorithm 5): scan the in-memory summarizations with
  the mindist lower bound, fetch only unpruned raw series.

Materialized (``Coconut-Tree-Full``) stores raw series co-sorted with keys;
non-materialized stores offsets into the caller's raw array (gathers at query
time).

The columns are tensors on one device.  :func:`build` runs on the card
unless the caller asks for the CPU: a tensor input stays on its own device,
any other input goes to ``"cuda"`` by default, and with no CUDA device the
call raises unless ``device="cpu"`` is passed.  On the card the
summarization is the ``fused_build`` kernel (``zorder`` for a build given
precomputed codes, ``sax_summarize`` + ``zorder`` for the seed probe's
query keys); on the CPU their plain twins.  :func:`save` / :func:`load`
persist a tree as one on-disk segment file (:mod:`repro_torch.storage`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import keys as K
from . import summarization as S
from .metrics import IOStats

__all__ = ["CoconutTree", "build", "approx_search", "exact_search",
           "approx_search_batch", "exact_search_batch",
           "exact_search_budgeted", "merge_trees", "SearchStats",
           "from_numpy", "to_numpy", "save", "load"]


@dataclasses.dataclass
class CoconutTree:
    """Sorted, contiguous Coconut-Tree index (tensors on one device)."""
    keys: torch.Tensor                  # [N, n_words] int64 words, z-order sorted
    codes: torch.Tensor                 # [N, w] uint8 SAX words (sorted order)
    paas: torch.Tensor                  # [N, w] float32 PAA (sorted order)
    offsets: torch.Tensor               # [N] int64: position in original raw file
    raw: Optional[torch.Tensor]         # [N, L] sorted raw series (materialized)
    raw_ref: Optional[torch.Tensor]     # [N, L] *unsorted* raw (non-materialized)
    timestamps: Optional[torch.Tensor]  # [N] insertion times (optional)
    ids: Optional[torch.Tensor] = None  # [N] global row ids (sorted order)
    cfg: S.SummaryConfig = dataclasses.field(
        default_factory=S.SummaryConfig)
    leaf_size: int = 256

    # -- conveniences --------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def n_leaves(self) -> int:
        return -(-self.n // self.leaf_size)

    @property
    def materialized(self) -> bool:
        return self.raw is not None

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def series(self, idx) -> torch.Tensor:
        """Fetch raw series rows for sorted-order indices ``idx`` (a
        tensor, or a slice: then a view of a materialized tree's rows)."""
        if self.raw is not None:
            return self.raw[idx]
        return self.raw_ref[self.offsets[idx]]

    def series_source(self, idx: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(base, rows)`` with ``base[rows] == series(idx)``: what the
        gathered ED kernel reads instead of a copy of the rows."""
        if self.raw is not None:
            return self.raw, idx
        return self.raw_ref, self.offsets[idx]

    @property
    def fences(self) -> torch.Tensor:
        """First key of every leaf — the (implicit) internal-node layer."""
        return self.keys[:: self.leaf_size]


# SearchStats lives with the merger (the pipeline piece that owns query
# accounting); re-exported here because every search entry point returns one.
from ..query.merger import SearchStats  # noqa: E402
from ..query.merger import merge_topk as _merge_topk  # noqa: E402


def _device_for(raw, device) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else a
    tensor's own device, else the card.  No CUDA device and no explicit
    CPU request is an error, never a silent CPU run."""
    if device is not None:
        dev = torch.device(device)
    elif isinstance(raw, torch.Tensor):
        dev = raw.device
    else:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def _as(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.as_tensor(a if a.flags.writeable else a.copy())
    return x.to(device=dev, dtype=dtype)


def _report_column(tree: CoconutTree) -> torch.Tensor:
    """Column reported as the 'offset' of an answer: the global row id
    when the tree carries ids, else the position in the original raw
    file."""
    return tree.ids if tree.ids is not None else tree.offsets


def build(raw,
          cfg: S.SummaryConfig,
          *,
          leaf_size: int = 256,
          materialized: bool = True,
          timestamps=None,
          ids=None,
          io: Optional[IOStats] = None,
          znorm: bool = False,
          paas=None,
          codes=None,
          device=None) -> CoconutTree:
    """Bulk-load a Coconut-Tree from raw series ``[N, L]`` (Algorithm 3).

    summarize -> invert (z-order) -> sort -> (optionally) co-sort raw.
    O(N/B) block transfers in the paper's model: the raw file is streamed
    once (seq read), the sorted summaries written once (seq write), and
    the materialized variant rewrites the raw data once more.

    ``paas``/``codes``: optional precomputed summaries in row order (both
    or neither).  ``device``: where the tree lives (see the module doc).
    """
    dev = _device_for(raw, device)
    raw = _as(raw, torch.float32, dev)
    if znorm:
        raw = S.znormalize(raw)
    n = raw.shape[0]
    if paas is None or codes is None:
        paas, codes, keys = ops.summarize_and_key(raw, cfg)
    else:
        paas = _as(paas, torch.float32, dev)
        codes = _as(codes, torch.uint8, dev)
        keys = ops.zorder(codes, cfg)
    order = K.lexsort_keys(keys)
    ts = _as(timestamps, torch.int64, dev)[order] if timestamps is not None \
        else None
    ids_sorted = _as(ids, torch.int64, dev)[order] if ids is not None \
        else None
    if io is not None:
        io.seq_read(n)            # pass over the raw file (summarize)
        io.seq_write(n)           # write sorted summaries
        io.seq_read(n)            # merge pass read
        io.seq_write(n)           # merge pass write
        if materialized:
            io.seq_read(n)        # extra pass: co-sort raw into leaves
            io.seq_write(n)
    return CoconutTree(
        keys=keys[order], codes=codes[order], paas=paas[order],
        offsets=order, raw=raw[order] if materialized else None,
        raw_ref=None if materialized else raw,
        timestamps=ts, ids=ids_sorted, cfg=cfg, leaf_size=leaf_size)


# ---------------------------------------------------------------------------
# Approximate search (Algorithm 4)
# ---------------------------------------------------------------------------

def _queries_on(tree: CoconutTree, queries) -> torch.Tensor:
    q = _as(queries, torch.float32, tree.device)
    return q[None, :] if q.ndim == 1 else q


def _seed_index(tree: CoconutTree, queries, radius_leaves: int = 1
                ) -> torch.Tensor:
    """Vectorized Algorithm 4 probe: one binary search for the whole
    batch.  queries ``[Q, L]`` -> sorted-order row indices ``[Q, span]``
    around each query's z-order insertion point (clipped to the tree)."""
    cfg = tree.cfg
    q = _queries_on(tree, queries)
    _, q_codes = ops.sax_summarize(q, cfg)
    pos = K.searchsorted_keys(tree.keys, ops.zorder(q_codes, cfg))  # [Q]
    span = 2 * radius_leaves * tree.leaf_size
    start = (pos - span // 2).clamp(0, max(tree.n - span, 0))
    idx = start[:, None] + torch.arange(span, device=tree.device)[None, :]
    return idx.clamp(0, tree.n - 1)


def _approx_candidates_batch(tree: CoconutTree, queries,
                             radius_leaves: int = 1):
    """(dists ``[Q, span]``, idx ``[Q, span]``) for the leaves around each
    query's sorted position, through the gathered ED kernel."""
    q = _queries_on(tree, queries)
    idx = _seed_index(tree, q, radius_leaves=radius_leaves)
    base, rows = tree.series_source(idx)
    return ops.batch_euclid_multi(q, base, idx=rows), idx


def approx_search(tree: CoconutTree, query, *,
                  k: int = 1,
                  radius_leaves: int = 1,
                  io: Optional[IOStats] = None
                  ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Approximate k-NN: visit the leaves around the query's sorted position.

    Thin wrapper over :func:`approx_search_batch` with Q=1: returns
    (dists ``[k]``, offsets ``[k]``, stats).
    """
    d, off, stats = approx_search_batch(
        tree, _queries_on(tree, query), k=k, radius_leaves=radius_leaves,
        io=io)
    return d[0], off[0], stats


def approx_search_batch(tree: CoconutTree, queries, *,
                        k: int = 1, radius_leaves: int = 1,
                        io: Optional[IOStats] = None
                        ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Batched approximate k-NN.

    Returns (dists ``[Q, k]``, offsets ``[Q, k]``, stats); ``offsets`` index
    the original raw file, padded with -1 (dist inf) when fewer than k
    candidates exist.
    """
    q = _queries_on(tree, queries)
    nq = q.shape[0]
    d, idx = _approx_candidates_batch(tree, q, radius_leaves=radius_leaves)
    d = d.cpu().numpy()
    idx = idx.cpu().numpy()
    offs = _report_column(tree).cpu().numpy()[idx]               # [Q, span]
    out_d = np.empty((nq, k), np.float32)
    out_o = np.empty((nq, k), np.int64)
    for qi in range(nq):
        out_d[qi], out_o[qi] = _merge_topk(d[qi], offs[qi], k)
    stats = SearchStats(candidates=len(np.unique(idx)),
                        leaves_touched=2 * radius_leaves,
                        exact=False, queries=nq)
    stats.candidates_per_query = np.full(nq, d.shape[1], np.int64)
    stats.leaves_per_query = np.full(nq, 2 * radius_leaves, np.int64)
    if io is not None:
        io.rand_read(2 * radius_leaves * nq)
    return out_d, out_o, stats


# ---------------------------------------------------------------------------
# Exact search: SIMS (Algorithm 5)
# ---------------------------------------------------------------------------

def exact_search(tree: CoconutTree, query, *,
                 k: int = 1,
                 radius_leaves: int = 1,
                 chunk: int = 4096,
                 io: Optional[IOStats] = None,
                 mindist_fn=None,
                 ts_min: Optional[int] = None,
                 bsf: Optional[float] = None,
                 budget=None,
                 mode: str = "exact",
                 ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Exact k-NN via the skip-sequential SIMS scan.

    Thin wrapper over :func:`exact_search_batch` with Q=1 — one pipeline
    serves the single and batched paths, so the answer bits are
    identical by construction.  Returns (dists ``[k]``, offsets ``[k]``,
    stats).

    ``ts_min``: if set, restrict to entries with timestamp >= ts_min.
    ``bsf``: externally-known bound; it prunes the scan but is never
    returned as an answer.
    ``mindist_fn``: injectable bound with the BATCHED signature
    ``(q_paas [Q, w], codes [N, w]) -> [Q, N]``.
    ``budget`` / ``mode``: the recall/latency dial — see
    :func:`exact_search_batch`.
    """
    ext = None if bsf is None else np.asarray([bsf], np.float32)
    d, off, stats = exact_search_batch(
        tree, _queries_on(tree, query), k=k, radius_leaves=radius_leaves,
        chunk=chunk, io=io, mindist_fn=mindist_fn, ts_min=ts_min, bsf=ext,
        budget=budget, mode=mode)
    return d[0], off[0], stats


def _smallest_stable(md: torch.Tensor, budget: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``budget`` smallest bounds and their rows, ascending, ties to
    the lowest row (a stable sort; ``torch.topk`` on CUDA promises no
    order among ties)."""
    vals, rows = torch.sort(md, stable=True)
    return vals[:budget], rows[:budget]


def exact_search_budgeted(tree: CoconutTree, query, *, budget: int = 1024,
                          radius_leaves: int = 1):
    """Exact search with a fixed verification budget (fixed shapes: the
    serving path's form).

    Verifies the ``budget`` rows of smallest mindist — the whole tree's
    bound is one ``mindist`` launch at Q = 1 — taking ties in the bound
    by lowest row (a stable sort, as ``jax.lax.top_k`` does in the
    reference).  Returns (best_d, best_offset, certified) where
    ``certified`` is True iff the budget-th smallest mindist already
    reaches the best distance found, i.e. the answer is provably exact.
    """
    cfg = tree.cfg
    if not 1 <= budget <= tree.n:
        raise ValueError(f"budget must be in [1, {tree.n}], got {budget}")
    q = _queries_on(tree, query)[:1]
    d0, idx = _approx_candidates_batch(tree, q, radius_leaves=radius_leaves)
    d0, idx = d0[0], idx[0]
    seed = d0.min()
    md = ops.mindist(S.paa(q, cfg.segments)[0], tree.codes, cfg)      # [N]
    cand_md, order = _smallest_stable(md, budget)
    base, rows = tree.series_source(order)
    d = ops.batch_euclid_multi(q, base, idx=rows[None, :])[0]
    d = torch.where(cand_md < torch.minimum(seed, d.min()), d,
                    torch.full_like(d, float("inf")))
    best_i = torch.argmin(d)
    best_d = torch.minimum(d[best_i], seed)
    from_seed = seed <= d[best_i]
    rep = _report_column(tree)
    best_off = torch.where(from_seed, rep[idx[torch.argmin(d0)]],
                           rep[order[best_i]])
    certified = cand_md[budget - 1] >= best_d
    return (np.float32(best_d.item()), np.int64(best_off.item()),
            bool(certified.item()))


def exact_search_batch(tree: CoconutTree, queries, *,
                       k: int = 1, radius_leaves: int = 1,
                       chunk: int = 4096,
                       io: Optional[IOStats] = None,
                       mindist_fn=None,
                       ts_min: Optional[int] = None,
                       bsf: Optional[np.ndarray] = None,
                       budget=None,
                       mode: str = "exact",
                       ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Batched exact k-NN via ONE amortized SIMS scan.

    Delegates to the query pipeline (:mod:`repro_torch.query`): the
    partition's leaf fences price every leaf with a z-order envelope
    mindist bound, the executor scans only the surviving leaves
    cheapest-bound-first, verifies unpruned rows with the batched
    Euclidean kernel, and the merger chains the per-query k-th-best bound
    across groups.

    ``bsf``: optional ``[Q]`` per-query external bounds.
    ``mindist_fn``: injectable lower-bound kernel,
    ``(q_paas [Q, w], codes [B, w]) -> [Q, B]`` (defaults to
    :func:`repro_torch.kernels.ops.mindist_batch`).
    ``budget`` / ``mode="approx"``: the recall/latency dial — drain the
    best-first leaf frontier under a :class:`repro_torch.query.Budget` (an
    int is ``max_leaves`` shorthand) and report the certified lower-bound
    gap in ``stats.gap``; passing ``budget`` implies approx mode, and
    ``mode="approx"`` with no budget is bit-identical to exact with
    ``gap == 0``.
    Returns (dists ``[Q, k]``, offsets ``[Q, k]``, batch stats); with k=1
    row qi matches ``exact_search(tree, queries[qi])``.
    """
    from ..query import Partition, approx_knn, exact_knn
    if mode not in ("exact", "approx"):
        raise ValueError(f"mode must be 'exact' or 'approx', got {mode!r}")
    if budget is not None or mode == "approx":
        return approx_knn([Partition.from_tree(tree)], queries, tree.cfg,
                          k=k, budget=budget, ts_min=ts_min, bsf=bsf,
                          radius_leaves=radius_leaves, chunk=chunk, io=io,
                          mindist_fn=mindist_fn)
    return exact_knn([Partition.from_tree(tree)], queries, tree.cfg,
                     k=k, ts_min=ts_min, bsf=bsf,
                     radius_leaves=radius_leaves, chunk=chunk, io=io,
                     mindist_fn=mindist_fn)


# ---------------------------------------------------------------------------
# Merging (LSM compaction building block)
# ---------------------------------------------------------------------------

def merge_trees(a: CoconutTree, b: CoconutTree, *,
                io: Optional[IOStats] = None) -> CoconutTree:
    """Sort-merge two Coconut-Trees into one (LSM compaction, Sec. 4.4):
    concat + lexsort on the device; in the paper's I/O model a sequential
    read of both runs and a sequential write of the result."""
    if a.cfg != b.cfg:
        raise ValueError("cannot merge trees with different summary configs")
    if a.materialized != b.materialized:
        raise ValueError("cannot merge materialized with non-materialized")
    keys = torch.cat([a.keys, b.keys])
    # offsets in the merged view address a virtual concatenated raw file
    offs = torch.cat([a.offsets, b.offsets + a.n])
    ts = None
    if a.timestamps is not None and b.timestamps is not None:
        ts = torch.cat([a.timestamps, b.timestamps])
    ids = None
    if a.ids is not None and b.ids is not None:
        ids = torch.cat([a.ids, b.ids])
    order = K.lexsort_keys(keys)
    raw = raw_ref = None
    if a.materialized:
        raw = torch.cat([a.raw, b.raw])[order]
    else:
        raw_ref = torch.cat([a.raw_ref, b.raw_ref])
    if io is not None:
        io.seq_read(a.n + b.n)
        io.seq_write(a.n + b.n)
    return CoconutTree(
        keys=keys[order], codes=torch.cat([a.codes, b.codes])[order],
        paas=torch.cat([a.paas, b.paas])[order], offsets=offs[order],
        raw=raw, raw_ref=raw_ref,
        timestamps=None if ts is None else ts[order],
        ids=None if ids is None else ids[order],
        cfg=a.cfg, leaf_size=a.leaf_size)


# ---------------------------------------------------------------------------
# Carrying an index across: numpy columns <-> CoconutTree
# ---------------------------------------------------------------------------

_COLUMNS = {"keys": torch.int64, "codes": torch.uint8,
            "paas": torch.float32, "offsets": torch.int64,
            "raw": torch.float32, "raw_ref": torch.float32,
            "timestamps": torch.int64, "ids": torch.int64}
_NP_OUT = {"keys": np.uint32, "codes": np.uint8, "paas": np.float32,
           "offsets": np.int32, "raw": np.float32, "raw_ref": np.float32,
           "timestamps": np.int32, "ids": np.int64}


def from_numpy(columns: Dict[str, np.ndarray], *, series_len: int,
               segments: int, bits: int, leaf_size: int,
               device=None) -> CoconutTree:
    """A tree from numpy columns — the index plays the role weights play
    for a model.  ``columns``: ``keys`` ([N, n_words] 32-bit words),
    ``codes``, ``paas``, ``offsets``, ``raw`` or ``raw_ref``, and
    optionally ``timestamps`` and ``ids``, all in sorted order (as a
    built tree holds them).  ``device`` defaults to the card."""
    dev = _device_for(None, device)
    cols = {}
    for name, dtype in _COLUMNS.items():
        v = columns.get(name)
        cols[name] = None if v is None else _as(
            np.asarray(v).astype(np.int64) if dtype == torch.int64
            else np.asarray(v), dtype, dev)
    if (cols["raw"] is None) == (cols["raw_ref"] is None):
        raise ValueError("from_numpy: pass exactly one of raw / raw_ref")
    return CoconutTree(**cols,
                       cfg=S.SummaryConfig(series_len, segments, bits),
                       leaf_size=leaf_size)


def to_numpy(tree: CoconutTree) -> Dict[str, Optional[np.ndarray]]:
    """Inverse of :func:`from_numpy`: the tree's columns as numpy arrays
    in the reference's types (uint32 key words, int32 offsets)."""
    out = {}
    for name, np_dtype in _NP_OUT.items():
        v = getattr(tree, name)
        out[name] = None if v is None else v.cpu().numpy().astype(np_dtype)
    return out


# ---------------------------------------------------------------------------
# Persistence (delegates to the storage engine)
# ---------------------------------------------------------------------------

def save(tree: CoconutTree, path: str, *,
         io: Optional[IOStats] = None) -> None:
    """Persist the tree as one self-describing on-disk segment file."""
    from ..storage.segment import write_segment
    write_segment(path, tree, io=io)


def load(path: str, device=None) -> CoconutTree:
    """Reopen a segment file written by :func:`save` (or by the reference
    package) as a ``CoconutTree`` on ``device`` (the card by default).

    The columns are already sorted on disk, so searches on the loaded tree
    are identical to the tree that was saved.
    """
    from ..storage.segment import Segment
    seg = Segment.open(path)
    try:
        return seg.to_tree(device=device)
    finally:
        seg.close()
