"""PAA / SAX / invSAX summarization of data series (paper Secs. 2, 4.1).

A data series is a z-normalized float vector of length ``L``.  Its PAA
(Piecewise Aggregate Approximation) is the mean over ``w`` equal segments; the
SAX word quantizes each PAA value into ``2**b`` regions whose boundaries are
standard-normal quantiles ("breakpoints"), so regions are equiprobable for
z-normalized data.  The *sortable* summarization (invSAX) bit-interleaves the
SAX word onto a z-order curve (see :mod:`repro_torch.core.keys`).

The lower-bounding distance ``mindist`` (used by SIMS exact search to prune)
is the classic iSAX bound: per segment, the squared distance from the query's
PAA value to the candidate's region, scaled by L/w — provably <= true ED.

Everything here is plain PyTorch on the tensor's own device; the hot-path
versions of ``summarize``/``invsax_keys`` (the ``fused_build`` kernel) and
of the batched bound (``mindist_batch``) sit behind
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
from scipy.special import ndtri

from . import keys as K

__all__ = [
    "SummaryConfig",
    "breakpoints",
    "region_bounds",
    "znormalize",
    "paa",
    "sax_encode",
    "summarize",
    "invsax_keys",
    "mindist_sq",
    "mindist_sq_batch",
    "mindist_sq_table",
    "euclidean_sq",
    "euclidean_sq_batch",
]


@dataclasses.dataclass(frozen=True)
class SummaryConfig:
    """Summarization hyper-parameters (paper default: 16 segments, 8 bits)."""
    series_len: int = 256     # L
    segments: int = 16        # w
    bits: int = 8             # b (cardinality 2**b per segment)

    def __post_init__(self):
        if self.series_len % self.segments != 0:
            raise ValueError(
                f"series_len={self.series_len} must be divisible by "
                f"segments={self.segments}")
        if not (1 <= self.bits <= 8):
            raise ValueError("bits must be in [1, 8]")

    @property
    def n_words(self) -> int:
        return K.n_key_words(self.segments, self.bits)

    @property
    def cardinality(self) -> int:
        return 1 << self.bits

    @property
    def seg_len(self) -> int:
        return self.series_len // self.segments


@functools.lru_cache(maxsize=None)
def _breakpoints_np(bits: int) -> np.ndarray:
    """Standard-normal quantile breakpoints: 2**b - 1 boundaries (float32),
    from the inverse normal CDF in float64 then rounded once."""
    card = 1 << bits
    qs = np.arange(1, card, dtype=np.float64) / card
    return ndtri(qs).astype(np.float32)


def breakpoints(bits: int, device=None) -> torch.Tensor:
    """Region boundaries, shape ``[2**b - 1]``, ascending."""
    return torch.tensor(_breakpoints_np(bits), device=device)


def region_bounds(bits: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-code (lower, upper) bounds, shape ``[2**b]`` each, +/-inf at ends."""
    bps = _breakpoints_np(bits)
    lower = np.concatenate([[-np.inf], bps]).astype(np.float32)
    upper = np.concatenate([bps, [np.inf]]).astype(np.float32)
    return (torch.tensor(lower, device=device),
            torch.tensor(upper, device=device))


def znormalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Z-normalize each series (paper Sec. 2: required preprocessing)."""
    mu = x.mean(dim=-1, keepdim=True)
    sd = x.std(dim=-1, keepdim=True, correction=0)
    return (x - mu) / (sd + eps)


def paa(x: torch.Tensor, segments: int) -> torch.Tensor:
    """Piecewise Aggregate Approximation: ``[..., L] -> [..., w]``.

    Each segment is summed in index order, then divided by its length —
    the order the ``fused_build`` kernel uses, so the two agree bit for
    bit on any device.  The length divides as a tensor on ``x``'s device:
    divided by a Python number, a CUDA tensor is multiplied by its
    reciprocal, which can differ in the last bit where the length is not a
    power of two."""
    *lead, L = x.shape
    if L % segments != 0:
        raise ValueError(f"series length {L} not divisible by w={segments}")
    seg = L // segments
    r = x.reshape(*lead, segments, seg)
    acc = r[..., 0]
    for e in range(1, seg):
        acc = acc + r[..., e]
    return acc / torch.full((), seg, dtype=acc.dtype, device=acc.device)


def sax_encode(paa_vals: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize PAA values into SAX codes ``[..., w]`` (uint8 region ids)."""
    bps = breakpoints(bits, device=paa_vals.device)
    # number of breakpoints <= value  ==  region index in [0, 2**b - 1]
    codes = torch.searchsorted(bps, paa_vals.contiguous(), right=True)
    return codes.to(torch.uint8)


def summarize(x: torch.Tensor, cfg: SummaryConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Series ``[N, L]`` -> (PAA ``[N, w]`` float32, SAX codes ``[N, w]`` uint8)."""
    p = paa(x.to(torch.float32), cfg.segments)
    return p, sax_encode(p, cfg.bits)


def invsax_keys(codes: torch.Tensor, cfg: SummaryConfig) -> torch.Tensor:
    """SAX codes -> sortable z-order keys ``[N, n_words]`` (int64 words)."""
    return K.interleave_codes(codes, w=cfg.segments, b=cfg.bits)


def _bound_gaps(q: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor
                ) -> torch.Tensor:
    below = torch.where(q < lb, lb - q, 0.0)
    above = torch.where(q > ub, q - ub, 0.0)
    return below + above


def mindist_sq(query_paa: torch.Tensor, codes: torch.Tensor,
               cfg: SummaryConfig) -> torch.Tensor:
    """Squared iSAX lower bound between a query PAA ``[w]`` and codes ``[N, w]``.

    mindist(q, c)^2 = (L/w) * sum_j  dist(q_j, region(c_j))^2  <=  ED(q, s)^2
    for every series ``s`` whose SAX word is ``c``.
    """
    return mindist_sq_batch(query_paa[None, :], codes, cfg)[0]


def mindist_sq_batch(query_paas: torch.Tensor, codes: torch.Tensor,
                     cfg: SummaryConfig) -> torch.Tensor:
    """Batched iSAX lower bound: queries ``[Q, w]``, codes ``[N, w]`` -> ``[Q, N]``."""
    lower, upper = region_bounds(cfg.bits, device=codes.device)
    c = codes.to(torch.int64)
    d = _bound_gaps(query_paas[:, None, :], lower[c][None], upper[c][None])
    return (cfg.series_len / cfg.segments) * torch.sum(d * d, dim=-1)


def euclidean_sq(query: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """Squared ED between query ``[L]`` and series ``[N, L]`` -> ``[N]``."""
    diff = series - query[None, :]
    return torch.sum(diff * diff, dim=-1)


def euclidean_sq_batch(queries: torch.Tensor,
                       series: torch.Tensor) -> torch.Tensor:
    """Squared ED between queries ``[Q, L]`` and series ``[N, L]`` -> ``[Q, N]``."""
    diff = series[None, :, :] - queries[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def mindist_sq_table(query_paa: torch.Tensor, codes: torch.Tensor,
                     cfg: SummaryConfig) -> torch.Tensor:
    """Table-driven mindist: fold the query into a ``[w, 2**b]`` per-segment
    distance table, then one flat gather per code.  Same numbers as
    :func:`mindist_sq` (each table entry is the same per-segment term)."""
    lower, upper = region_bounds(cfg.bits, device=codes.device)
    d = _bound_gaps(query_paa[:, None], lower[None, :], upper[None, :])
    table = d * d                                        # [w, 2**b]
    card = 1 << cfg.bits
    idx = codes.to(torch.int64) + (
        torch.arange(cfg.segments, device=codes.device) * card)[None, :]
    per_seg = table.reshape(-1)[idx]                     # [N, w], one gather
    return (cfg.series_len / cfg.segments) * torch.sum(per_seg, dim=-1)
