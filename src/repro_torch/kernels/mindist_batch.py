"""Wrapper of the ``mindist_batch`` CUDA kernel (``csrc/mindist_batch.cu``).

Batched squared iSAX lower bound: q_paas ``[Q, w]`` f32 x codes ``[N, w]``
uint8 -> ``[Q, N]`` f32.  Replaces the TPU kernels ``mindist_batch_pallas``
and (at Q = 1) ``mindist_pallas`` of the reference package.  A CPU tensor
goes to the plain twin :func:`repro_torch.kernels.ref.mindist_batch_ref`.

The launch plan of the bound tile (``csrc/bound_tile.cuh``), which this
kernel and ``unpack_mindist`` share, is computed here by
:func:`launch_plan`, so that it can be checked without a card; the kernels
read it from their arguments.  The tile's rows per block (``ROWS``) and its
shared memory are constants of the kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import loader, ref

__all__ = ["mindist_batch", "launch_plan", "LaunchPlan"]

NAME = "mindist_batch"
MAX_W = 64
SMS = 132                 # streaming multiprocessors of an H100
ROWS = 64                 # rows per block, one thread each: kRows in C
MAX_QT = 4                # queries per thread, unrolled in registers
MAX_GRID_Y = 65_535


class LaunchPlan(NamedTuple):
    qt: int          # queries per block, each thread computing all of them
    grid: tuple      # (row tiles, query tiles)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def launch_plan(nq: int, n: int, w: int) -> LaunchPlan:
    """The launch of one bound call over ``nq`` queries and ``n`` rows of
    ``w`` symbols: blocks of ``ROWS`` threads, one row each, every thread
    computing ``qt`` queries (the next power of two of Q, at most 4; more
    queries go to ``blockIdx.y``), halved while the grid has fewer blocks
    than the card has SMs, so the main path's 64 x 2000 launch has 32 x 16
    = 512 blocks, and a launch of 2 to 16 queries over one leaf spreads
    over more SMs.  Raises on a shape the kernels do not take."""
    if not (nq >= 1 and 1 <= n < 2 ** 31 and 1 <= w <= MAX_W):
        raise ValueError(f"{NAME}: no kernel for Q={nq} N={n} w={w}")
    qt = min(MAX_QT, 1 << (nq - 1).bit_length())
    while qt > 1 and _ceil(n, ROWS) * _ceil(nq, qt) < SMS:
        qt //= 2
    if _ceil(nq, qt) > MAX_GRID_Y:
        raise ValueError(f"{NAME}: no kernel for Q={nq}")
    return LaunchPlan(qt, (_ceil(n, ROWS), _ceil(nq, qt)))


def mindist_batch(q_paas: torch.Tensor, codes: torch.Tensor,
                  lower: torch.Tensor, upper: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """``lower``/``upper``: the ``[2**b]`` region tables (+/-inf ends)."""
    if codes.device.type == "cpu":
        return ref.mindist_batch_ref(q_paas, codes, lower, upper, scale)
    dev = loader.require_cuda(NAME, q_paas, codes, lower, upper)
    loader.require(NAME, q_paas, torch.float32, 2)
    loader.require(NAME, codes, torch.uint8, 2)
    loader.require(NAME, lower, torch.float32, 1)
    loader.require(NAME, upper, torch.float32, 1)
    nq, w = q_paas.shape
    n = codes.shape[0]
    card = lower.shape[0]
    if (codes.shape[1] != w or upper.shape[0] != card
            or not 1 <= card <= 256 or not 1 <= w <= MAX_W):
        raise ValueError(f"{NAME}: q_paas {tuple(q_paas.shape)}, codes "
                         f"{tuple(codes.shape)}, tables {card}; w <= {MAX_W}")
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if nq == 0 or n == 0:
        return out
    plan = launch_plan(nq, n, w)
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_mindist_batch(
            q_paas.data_ptr(), codes.data_ptr(), lower.data_ptr(),
            upper.data_ptr(), out.data_ptr(), nq, n, w, card, float(scale),
            plan.qt, *plan.grid, loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return out
