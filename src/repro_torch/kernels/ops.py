"""Public kernel entry points, dispatched by the tensor's device.

A CUDA tensor launches the hand-written kernel (or the call raises); a CPU
tensor takes the kernel's plain twin in :mod:`repro_torch.kernels.ref`.
There is no mode argument, no environment override and no fallback from a
failed launch to a twin.  These are the entry points the index code uses.
The four the reference instruments (``mindist_batch``,
``mindist_batch_packed``, ``scan_verify``, ``mesh_scan``) are wrapped in
:func:`repro_torch.obs.profile.profiled`: one global check per call
while profiling is off.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from ..core import summarization as S
from ..obs.profile import profiled
from .batch_euclid import batch_euclid as _euclid_cross
from .batch_euclid import batch_euclid_gather as _euclid_gather
from .fused_build import fused_build as _fused_build
from .mesh_scan import mesh_scan_launch as _mesh_scan
from .mindist_batch import mindist_batch as _mindist_batch
from .pool_merge import MAX_K as POOL_MAX_K
from .pool_merge import pool_merge
from .sax_summarize import sax_summarize as _sax_summarize
from .scan_verify import scan_verify as _scan_verify
from .unpack_mindist import unpack_mindist as _unpack_mindist
from .zorder import zorder as _zorder

__all__ = ["mindist", "mindist_batch", "mindist_batch_packed",
           "batch_euclid", "batch_euclid_multi", "scan_verify", "mesh_scan",
           "sax_summarize", "zorder", "summarize_and_key", "pool_merge",
           "POOL_MAX_K"]


@functools.lru_cache(maxsize=None)
def _tables(bits: int, device: torch.device
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lower, upper, breakpoints) for ``bits`` on ``device``, made once."""
    lower, upper = S.region_bounds(bits, device=device)
    return lower, upper, S.breakpoints(bits, device=device)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def mindist(q_paa: torch.Tensor, codes: torch.Tensor,
            cfg: S.SummaryConfig) -> torch.Tensor:
    """Squared iSAX lower bound for all codes: ``[w] x [N, w] -> [N]``
    (the Q = 1 case of :func:`mindist_batch`)."""
    return mindist_batch(q_paa[None, :], codes, cfg)[0]


@profiled("mindist_batch")
def mindist_batch(q_paas: torch.Tensor, codes: torch.Tensor,
                  cfg: S.SummaryConfig) -> torch.Tensor:
    """Batched squared iSAX lower bound: ``[Q, w] x [N, w] -> [Q, N]``.

    One streaming pass over the (uint8) codes serves the whole batch.
    """
    lower, upper, _ = _tables(cfg.bits, codes.device)
    return _mindist_batch(_f32(q_paas), codes.to(torch.uint8).contiguous(),
                          lower, upper, cfg.series_len / cfg.segments)


@profiled("mindist_batch_packed")
def mindist_batch_packed(q_paas: torch.Tensor, packed: torch.Tensor,
                         cfg: S.SummaryConfig) -> torch.Tensor:
    """Batched lower bound over format-v3 *packed* code rows:
    ``[Q, w] x [N, ceil(w*b/8)] -> [Q, N]``, bit-equal to
    :func:`mindist_batch` on the decoded rows (the unpack is exact and the
    bound shares its routine), so answers never depend on which ran."""
    lower, upper, _ = _tables(cfg.bits, packed.device)
    return _unpack_mindist(_f32(q_paas), packed.to(torch.uint8).contiguous(),
                           lower, upper, cfg.series_len / cfg.segments,
                           w=cfg.segments, b=cfg.bits)


def batch_euclid(query: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """query ``[L]``, series ``[N, L]`` -> squared ED ``[N]``."""
    return batch_euclid_multi(query[None, :], series)[0]


def batch_euclid_multi(queries: torch.Tensor, series: torch.Tensor,
                       idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """queries ``[Q, L]``, series ``[N, L]`` -> squared ED ``[Q, N]``; with
    ``idx`` ``[Q, C]`` (row numbers of ``series``) the gathered form
    ``out[q, c] = ED(queries[q], series[idx[q, c]])`` -> ``[Q, C]``.

    Every ED of the port goes through this one routine, so a (query, row)
    pair has the same distance bits whatever batch or path computed it.
    """
    if idx is None:
        return _euclid_cross(_f32(queries), _f32(series))
    return _euclid_gather(_f32(queries), _f32(series),
                          idx.to(torch.int64).contiguous())


@profiled("scan_verify")
def scan_verify(queries: torch.Tensor, q_paas: torch.Tensor,
                codes: torch.Tensor, raw: torch.Tensor, bound: torch.Tensor,
                cfg: S.SummaryConfig, *, k: int = 1,
                dead: Optional[torch.Tensor] = None):
    """Fused SIMS scan+verify: one pass computing the iSAX lower bound,
    the bound-masked (early-abandoning) Euclidean verification, and the
    per-query top-k on the device.

    queries ``[Q, L]``, q_paas ``[Q, w]``, codes ``[B, w]``, raw
    ``[B, L]``, bound ``[Q]`` per-query best-so-far, ``dead`` optional
    ``[B]`` row filter (nonzero = excluded, e.g. window cuts).  Returns
    (dists ``[Q, k]`` inf-padded, row indices ``[Q, k]`` int32 with -1
    padding, verified counts ``[Q]`` int32, union-verified rows int32 —
    rows live for ANY query, the batch-level ``candidates`` figure).
    """
    lower, upper, _ = _tables(cfg.bits, codes.device)
    return _scan_verify(_f32(queries), _f32(q_paas),
                        codes.to(torch.uint8).contiguous(), _f32(raw),
                        lower, upper, _f32(bound), dead,
                        scale=cfg.series_len / cfg.segments, k=k)


@profiled("mesh_scan")
def mesh_scan(queries: torch.Tensor, q_paas: torch.Tensor,
              codes: Sequence[torch.Tensor], raw: Sequence[torch.Tensor],
              ids: Sequence[torch.Tensor], ts: Sequence[torch.Tensor],
              ts_min: Optional[torch.Tensor], bound: torch.Tensor,
              cfg: S.SummaryConfig, *, k: int = 1):
    """Whole-batch device-resident sharded scan over the pinned
    ``[S, cap, ...]`` shard stacks, given as one ``[S/D, cap, ...]`` block
    per mesh device (codes uint8, raw f32, ids int32 with -1 padding, ts
    int32).  On a CUDA device each sub-shard is one ``scan_verify``
    launch; on the CPU the plain per-device body runs.  The per-device
    lists are merged by selection on the first device.

    ``ts_min`` is a per-shard ``[S]`` int32 visibility cut or None,
    ``bound`` ``[Q]`` the strict per-query best-so-far.  Returns (dists
    ``[Q, k]``, global ids ``[Q, k]`` int32 with -1 padding, counts
    ``[S, Q]`` int32).  Oracle: ``ref.mesh_scan_ref``.
    """
    tables = [_tables(cfg.bits, c.device)[:2] for c in codes]
    return _mesh_scan(_f32(queries), _f32(q_paas), codes, raw, ids, ts,
                      ts_min, _f32(bound), tables,
                      scale=cfg.series_len / cfg.segments, k=k)


def sax_summarize(x: torch.Tensor, cfg: S.SummaryConfig):
    """Raw ``[N, L]`` -> (paa f32 ``[N, w]``, codes uint8 ``[N, w]``): the
    first construction stage (the second is :func:`zorder`)."""
    _, _, bps = _tables(cfg.bits, x.device)
    return _sax_summarize(_f32(x), bps, segments=cfg.segments, bits=cfg.bits)


def zorder(codes: torch.Tensor, cfg: S.SummaryConfig) -> torch.Tensor:
    """SAX codes ``[N, w]`` -> z-order keys ``[N, n_words]`` int64."""
    return _zorder(codes.to(torch.uint8).contiguous(), w=cfg.segments,
                   b=cfg.bits)


def summarize_and_key(x: torch.Tensor, cfg: S.SummaryConfig):
    """Fused construction pass: raw ``[N, L]`` -> (paa f32 ``[N, w]``,
    codes uint8 ``[N, w]``, keys ``[N, n_words]`` int64) in one sweep."""
    _, _, bps = _tables(cfg.bits, x.device)
    return _fused_build(_f32(x), bps, segments=cfg.segments, bits=cfg.bits)
