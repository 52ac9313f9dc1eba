"""Wrapper of the ``sax_summarize`` CUDA kernel (``csrc/sax_summarize.cu``).

Raw ``[N, L]`` f32 -> (PAA ``[N, w]`` f32, SAX codes ``[N, w]`` uint8), each
code the number of breakpoints <= its PAA value.  Replaces the TPU kernel
``sax_summarize_pallas`` of the reference package.  A CPU tensor goes to the
plain twin :func:`repro_torch.kernels.ref.sax_summarize_ref`.

The launch plan of the summarize tile (``csrc/summarize_tile.cuh``), which
this kernel and ``fused_build`` share, is computed here by
:func:`launch_plan`, so that it can be checked without a card: a block of
``THREADS`` threads holds one (row, segment) pair each, so a tile is
``THREADS // w`` whole rows, and a persistent grid of at most ``SMS *
BLOCKS_PER_SM`` blocks walks the tiles (block ``b`` takes tiles ``b, b +
grid, ...``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import loader, ref

__all__ = ["sax_summarize", "launch_plan", "LaunchPlan"]

NAME = "sax_summarize"
SMS = 132                 # streaming multiprocessors of an H100
THREADS = 256             # (row, segment) pairs a block: kSumThreads in C
BLOCKS_PER_SM = 4         # resident blocks an SM: kSumBlocksPerSm in C


class LaunchPlan(NamedTuple):
    rows: int        # rows a tile
    grid: int        # blocks, each walking every grid-th tile


@functools.lru_cache(maxsize=4096)
def launch_plan(n: int, w: int) -> LaunchPlan:
    """The launch of one summarize call over ``n`` rows of ``w``
    segments: tiles of ``THREADS // w`` rows (one row, its segments taken
    ``THREADS`` at a time, when ``w > THREADS``) and one block a tile up to
    ``BLOCKS_PER_SM`` blocks on each SM.  Raises on a shape the kernels do
    not take."""
    if not (1 <= n < 2 ** 62 and w >= 1):
        raise ValueError(f"{NAME}: no kernel for N={n} w={w}")
    rows = THREADS // w if w <= THREADS else 1
    return LaunchPlan(rows, min(-(-n // rows), SMS * BLOCKS_PER_SM))


def sax_summarize(x: torch.Tensor, bps: torch.Tensor, *, segments: int,
                  bits: int):
    """``bps``: the ``[2**bits - 1]`` ascending breakpoints."""
    if x.device.type == "cpu":
        return ref.sax_summarize_ref(x, bps, segments=segments)
    dev = loader.require_cuda(NAME, x, bps)
    loader.require(NAME, x, torch.float32, 2)
    loader.require(NAME, bps, torch.float32, 1)
    n, L = x.shape
    if (L % segments or not 1 <= bits <= 8
            or bps.shape[0] != (1 << bits) - 1):
        raise ValueError(f"{NAME}: x {tuple(x.shape)}, w={segments}, "
                         f"b={bits}, {bps.shape[0]} breakpoints")
    paa = torch.empty((n, segments), dtype=torch.float32, device=dev)
    codes = torch.empty((n, segments), dtype=torch.uint8, device=dev)
    if n == 0:
        return paa, codes
    plan = launch_plan(n, segments)
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_sax_summarize(x.data_ptr(), bps.data_ptr(),
                                       paa.data_ptr(), codes.data_ptr(), n,
                                       L, segments, bits, plan.grid,
                                       loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return paa, codes
