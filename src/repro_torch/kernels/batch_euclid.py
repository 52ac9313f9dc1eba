"""Wrapper of the ``batch_euclid`` CUDA kernels (``csrc/batch_euclid.cu``).

Squared ED as a direct diff-square-sum, in two forms: the cross form
``[Q, L] x [N, L] -> [Q, N]`` and the gathered form
``out[q, c] = ED(queries[q], series[idx[q, c]])``.  Replaces the TPU kernel
``batch_euclid_pallas`` of the reference package (its Q = 1 case).  CPU
tensors go to the plain twins in :mod:`repro_torch.kernels.ref`, which sum
in the kernels' order.

The cross form's launch plan (the block's query tile, the chunks of L
staged in shared memory, the grid) is computed here, by
:func:`launch_plan`, so that it can be checked without a card; the kernel
reads it from its arguments.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import loader, ref

__all__ = ["batch_euclid", "batch_euclid_gather", "launch_plan",
           "LaunchPlan"]

NAME = "batch_euclid"
GATHER = "batch_euclid_gather"      # launch counter of the gathered form

WARP_Q, WARP_R = 4, 8     # a warp's register tile (the kernel's kWarpQ, kWarpR)
MAX_QTILE = 16            # queries per block; more go to blockIdx.y
SMEM_LIMIT = 48 * 1024    # the default dynamic shared memory of a block
MAX_GRID_Y = 65_535
LANES = 32


class LaunchPlan(NamedTuple):
    qtile: int       # queries per block (a multiple of WARP_Q); a block
    #                  covers WARP_R rows, a warp per WARP_Q of its queries
    lchunk: int      # columns of L staged at a time (a multiple of 32)
    chunks: int      # chunks of L, looped inside the block
    grid: tuple      # (row tiles, query tiles)

    @property
    def smem(self) -> int:
        """Shared-memory bytes of a block: one chunk of its query and row
        tiles."""
        return (self.qtile + WARP_R) * self.lchunk * 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def _tiling(nq: int, L: int) -> tuple:
    """(qtile, lchunk, chunks) for Q queries of length L: up to 16 queries
    a block, all of L in one chunk when it fits the default 48 KB, else
    equal chunks of whole 32-column steps."""
    if not (nq >= 1 and 1 <= L < 2 ** 31
            and _ceil(nq, MAX_QTILE) <= MAX_GRID_Y):
        raise ValueError(f"{NAME}: no kernel for Q={nq} L={L}")
    qtile = min(MAX_QTILE, _ceil(nq, WARP_Q) * WARP_Q)
    steps = _ceil(L, LANES)                      # 32-column steps
    chunks = _ceil(steps, SMEM_LIMIT // (4 * LANES * (qtile + WARP_R)))
    return qtile, _ceil(steps, chunks) * LANES, chunks


def launch_plan(nq: int, n: int, L: int) -> LaunchPlan:
    """The launch of one cross-form call: a block of up to four warps
    stacked along the queries (up to 16 queries, more go to
    ``blockIdx.y``) over one warp tile's 8 rows, so a launch has as many
    blocks as its rows and queries allow.  Raises on a shape the kernel
    does not take."""
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"{NAME}: no kernel for N={n}")
    qtile, lchunk, chunks = _tiling(nq, L)
    return LaunchPlan(qtile, lchunk, chunks,
                      (_ceil(n, WARP_R), _ceil(nq, qtile)))


def _check_queries(queries: torch.Tensor, series: torch.Tensor) -> None:
    loader.require(NAME, queries, torch.float32, 2)
    loader.require(NAME, series, torch.float32, 2)
    if queries.shape[1] != series.shape[1]:
        raise ValueError(f"{NAME}: queries {tuple(queries.shape)} vs series "
                         f"{tuple(series.shape)}")


def batch_euclid(queries: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """Cross form: queries ``[Q, L]``, series ``[N, L]`` -> ``[Q, N]``."""
    if series.device.type == "cpu":
        return ref.batch_euclid_ref(queries, series)
    dev = loader.require_cuda(NAME, queries, series)
    _check_queries(queries, series)
    nq, L = queries.shape
    n = series.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if nq == 0 or n == 0 or L == 0:
        return out.zero_()
    plan = launch_plan(nq, n, L)
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_euclid_cross(queries.data_ptr(), series.data_ptr(),
                                      out.data_ptr(), nq, n, L, plan.qtile,
                                      plan.lchunk, plan.chunks, *plan.grid,
                                      loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return out


def batch_euclid_gather(queries: torch.Tensor, series: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """Gathered form: queries ``[Q, L]``, series ``[M, L]``, idx ``[Q, C]``
    int64 row numbers in ``[0, M)`` -> ``[Q, C]``."""
    if series.device.type == "cpu":
        return ref.batch_euclid_gather_ref(queries, series, idx)
    dev = loader.require_cuda(NAME, queries, series, idx)
    _check_queries(queries, series)
    loader.require(NAME, idx, torch.int64, 2)
    nq, L = queries.shape
    if idx.shape[0] != nq:
        raise ValueError(f"{NAME}: idx {tuple(idx.shape)} for {nq} queries")
    c = idx.shape[1]
    out = torch.empty((nq, c), dtype=torch.float32, device=dev)
    if nq == 0 or c == 0 or L == 0:
        return out.zero_()
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_euclid_gather(queries.data_ptr(), series.data_ptr(),
                                       idx.data_ptr(), out.data_ptr(), nq, c,
                                       L, loader.stream_ptr(dev))
    loader.LAUNCHES[GATHER] += 1
    loader.check(GATHER, rc)
    return out
