"""Wrapper of the ``zorder`` CUDA kernel (``csrc/zorder.cu``).

SAX codes ``[N, w]`` uint8 -> z-order keys ``[N, n_words]`` int64 (32-bit
words, the port's key layout).  Replaces the TPU kernel ``zorder_pallas`` of
the reference package.  A CPU tensor goes to the plain twin
:func:`repro_torch.kernels.ref.zorder_ref`.

The launch plan is computed here by :func:`launch_plan`, so that it can be
checked without a card: a block of ``THREADS`` threads walks tiles of whole
rows on a persistent grid of at most ``SMS * BLOCKS_PER_SM`` blocks (block
``b`` takes tiles ``b, b + grid, ...``), each thread loading ``VEC`` codes
of a tile.  Where ``w`` is a power of two a tile is exactly ``THREADS *
VEC`` codes (``VEC`` rounds of the summarize tile's layout, one (row,
segment) pair a thread); at other widths, where a thread builds a row's
key, it is the most whole rows that fit, at most ``THREADS``, cut to a
multiple of 16 bytes so that every tile starts 16-byte aligned.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..core.keys import n_key_words
from . import loader, ref
from .sax_summarize import BLOCKS_PER_SM, SMS

__all__ = ["zorder", "launch_plan", "LaunchPlan"]

NAME = "zorder"
MAX_W = 64
THREADS = 256             # threads a block: kZThreads in C
VEC = 16                  # codes a thread loads a tile: kZVec in C


class LaunchPlan(NamedTuple):
    rows: int        # rows a tile
    grid: int        # blocks, each walking every grid-th tile


@functools.lru_cache(maxsize=4096)
def launch_plan(n: int, w: int) -> LaunchPlan:
    """The launch of one zorder call over ``n`` rows of ``w`` codes.
    Raises on a shape the kernel does not take."""
    if not (1 <= n < 2 ** 62 and 1 <= w <= MAX_W):
        raise ValueError(f"{NAME}: no kernel for N={n} w={w}")
    rows = THREADS * VEC // w
    if w & (w - 1):           # row_key: a thread a row
        rows = min(rows, THREADS)
    rows -= rows % (16 // math.gcd(w, 16))    # a multiple of 16 bytes
    return LaunchPlan(rows, min(-(-n // rows), SMS * BLOCKS_PER_SM))


def zorder(codes: torch.Tensor, *, w: int, b: int) -> torch.Tensor:
    if codes.device.type == "cpu":
        return ref.zorder_ref(codes, w=w, b=b)
    dev = loader.require_cuda(NAME, codes)
    loader.require(NAME, codes, torch.uint8, 2)
    if codes.shape[1] != w or not 1 <= w <= MAX_W or not 1 <= b <= 8:
        raise ValueError(f"{NAME}: codes {tuple(codes.shape)}, w={w}, b={b}; "
                         f"w <= {MAX_W}")
    n = codes.shape[0]
    nw = n_key_words(w, b)
    keys = torch.empty((n, nw), dtype=torch.int64, device=dev)
    if n == 0:
        return keys
    plan = launch_plan(n, w)
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_zorder(codes.data_ptr(), keys.data_ptr(), n, w, b,
                                nw, plan.rows, plan.grid,
                                loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return keys
