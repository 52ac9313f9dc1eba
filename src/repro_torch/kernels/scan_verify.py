"""Wrapper of the ``scan_verify`` CUDA kernel (``csrc/scan_verify.cu``).

The fused SIMS scan: lower bound, live mask, ED of the live pairs, per-query
top-k, live counts and the union count, in one launch.  Replaces the TPU
kernel ``scan_verify_pallas`` of the reference package.  A CPU tensor goes to
the plain twin :func:`repro_torch.kernels.ref.scan_verify_ref`.

The launch plan (rows per tile, queries per shared-memory chunk, grid,
the block's shared-memory regions and the list bytes) is computed here, by
:func:`launch_plan`, so that it can be checked without a card; the kernel
takes the regions' offsets from it and has no layout of its own.  The blocks' partial lists
and the counters (last-block ticket, union and per-query sums, left at zero
by every call) live in two buffers kept per (device, stream) and grown,
never allocated per call.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from . import loader, ref

__all__ = ["scan_verify", "launch_plan", "smem_layout", "list_bytes",
           "LaunchPlan", "SmemLayout", "REGIONS", "MAX_K"]

NAME = "scan_verify"
MAX_K = 64      # a top-k list lives in two registers per lane of a warp
MAX_W = 64
THREADS = 512   # per block (the kernel's kThreads)
SMEM_LIMIT = 232_448      # shared memory one H100 block can use
MIN_TILE, MAX_TILE = 8, 64
MAX_GRID = 128            # the fold walks at most 4 lists per lane
WORKSPACE_LIMIT = 256 << 20
H100_SMS = 132
FOLD_SCRATCH = THREADS * 8    # the fold's key per lane (kFoldScratch)


# the block's shared-memory regions, in the order of the kernel's Region
REGIONS = ("list", "pkey", "q", "rows", "paa", "lo", "hi", "bound", "mask",
           "pair", "cnt", "off", "tcnt", "qstate", "slot", "slotrow", "dead",
           "codes", "misc")


class SmemLayout(NamedTuple):
    offsets: tuple   # byte offset of each region of REGIONS
    sizes: tuple     # bytes each region holds (before rounding up)
    bytes: int       # shared-memory bytes of the block


class LaunchPlan(NamedTuple):
    tile: int        # rows per tile (a block strides over tiles)
    qchunk: int      # queries staged in shared memory at a time
    chunks: int      # query chunks, looped inside the block
    grid: int        # blocks
    smem: int        # shared-memory bytes per block
    offsets: tuple   # byte offset of each shared-memory region (REGIONS)
    lists: int       # bytes of the blocks' partial lists


def _up16(b: int) -> int:
    return -(-b // 16) * 16


def smem_layout(qc: int, tile: int, L: int, w: int, k: int, card: int,
                grid: int) -> SmemLayout:
    """The block's shared memory: the regions of REGIONS one after another,
    each starting 16-byte aligned, and at least what the last block's fold
    stages for one query (a list length and a first entry per block)
    beside its scratch."""
    nw = -(-qc // 32)
    sizes = (qc * k * 8,          # list: the block's lists [qc, k] u64
             tile * qc * 8,       # pkey: keys of the tile's pairs
             qc * L * 4,          # q: queries [qc, L]
             tile * L * 4,        # rows: live rows [<= tile, L]
             qc * w * 4,          # paa: PAAs [w, qc]
             card * 4, card * 4,  # lo, hi: breakpoint tables
             qc * 4,              # bound
             tile * nw * 4,       # mask: [tile, nw] query bits
             tile * qc * 4,       # pair: q << 8 | r, query-major
             qc * 4,              # cnt: live rows per query, tile
             (qc + 1) * 4,        # off: exclusive prefix of cnt
             qc * 4, qc * 4,      # tcnt (per query, block), qstate
             tile * 4, tile * 4,  # slot: row -> slot, slotrow: slot -> row
             tile * 4,            # dead: the tile's dead flags
             tile * w,            # codes: the tile's codes
             16)                  # misc: union, live rows, last
    offsets, at = [], 0
    for b in sizes:
        offsets.append(at)
        at += _up16(b)
    return SmemLayout(tuple(offsets), sizes,
                      max(at, grid * 9 + FOLD_SCRATCH + 32))


def list_bytes(grid: int, nq: int, k: int) -> int:
    """Every block's list lengths (a byte per query) and entries."""
    return _up16(nq * grid) + 8 * k * nq * grid


@functools.lru_cache(maxsize=1024)
def launch_plan(nq: int, n: int, L: int, w: int, k: int, card: int,
                sms: int = H100_SMS) -> LaunchPlan:
    """The launch of one call: tiles small enough that the grid covers the
    ``sms`` multiprocessors (8 to 64 rows), as many queries per chunk as
    fit beside them in shared memory (the chunks made equal), and a grid of
    at most 128 blocks whose lists fit the workspace limit.  Raises on a
    shape the kernel does not take."""
    if not (nq >= 1 and 1 <= n < 2 ** 31 and 1 <= w <= MAX_W
            and 1 <= k <= MAX_K and L >= 1 and card >= 1):
        raise ValueError(f"{NAME}: no kernel for Q={nq} N={n} L={L} w={w} "
                         f"k={k} card={card}")
    want = -(-n // sms)
    tile = MIN_TILE
    while tile < min(want, MAX_TILE):
        tile *= 2
    while True:
        grid = max(1, min(-(-n // tile), MAX_GRID,
                          (WORKSPACE_LIMIT - nq) // (8 * k * nq + nq)))
        lo, hi = 0, nq          # largest qc in [1, nq] that fits
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if smem_layout(mid, tile, L, w, k, card,
                           grid).bytes <= SMEM_LIMIT:
                lo = mid
            else:
                hi = mid - 1
        if lo >= 1:
            break
        if tile == 1:
            raise ValueError(f"{NAME}: L={L} is too long for shared memory")
        tile //= 2
    chunks = -(-nq // lo)
    qc = -(-nq // chunks)
    lay = smem_layout(qc, tile, L, w, k, card, grid)
    return LaunchPlan(tile, qc, chunks, grid, lay.bytes, lay.offsets,
                      list_bytes(grid, nq, k))


@functools.lru_cache(maxsize=1024)
def _offsets_arg(offsets: tuple):
    """The offsets as the C int array the entry point reads (kept alive by
    the cache)."""
    return (ctypes.c_int * len(offsets))(*offsets)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORKSPACE: dict = {}
_WS_LOCK = threading.Lock()


def _workspace(dev: torch.device, stream: int, nq: int, nbytes: int):
    """The (device, stream)'s counters (int32, at least 4 + nq) and list
    buffer (at least ``nbytes``), grown as needed.  New counters are zeroed
    once: the kernel needs them zero and leaves them zero.  The lists need
    no clearing.  Calls on one stream run in order, so they share both."""
    key = (dev.index, stream)
    with _WS_LOCK:
        ctr, lists = _WORKSPACE.get(key, (None, None))
        if ctr is None or ctr.numel() < 4 + nq:
            ctr = torch.zeros(max(4 + nq, 2 * (0 if ctr is None
                                               else ctr.numel())),
                              dtype=torch.int32, device=dev)
        if lists is None or lists.numel() < nbytes:
            lists = torch.empty(max(nbytes, 2 * (0 if lists is None
                                                 else lists.numel())),
                                dtype=torch.uint8, device=dev)
        _WORKSPACE[key] = (ctr, lists)
        return ctr, lists


def scan_verify(queries: torch.Tensor, q_paas: torch.Tensor,
                codes: torch.Tensor, raw: torch.Tensor,
                lower: torch.Tensor, upper: torch.Tensor,
                bound: torch.Tensor, dead: Optional[torch.Tensor], *,
                scale: float, k: int):
    """queries ``[Q, L]`` f32, q_paas ``[Q, w]`` f32, codes ``[N, w]``
    uint8, raw ``[N, L]`` f32, bound ``[Q]`` f32, dead ``[N]`` (nonzero =
    excluded) or None -> (dists ``[Q, k]``, rows ``[Q, k]`` int32,
    counts ``[Q]`` int32, union int32)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{NAME}: k={k} outside [1, {MAX_K}]")
    if codes.device.type == "cpu":
        if dead is None:
            dead = torch.zeros(codes.shape[0], dtype=torch.int32)
        return ref.scan_verify_ref(queries, q_paas, codes, raw, lower, upper,
                                   bound, dead, scale=scale, k=k)
    tensors = [queries, q_paas, codes, raw, lower, upper, bound]
    dev = loader.require_cuda(NAME, *tensors,
                              *([] if dead is None else [dead]))
    for t, dt, nd in zip(tensors, [torch.float32, torch.float32, torch.uint8,
                                   torch.float32, torch.float32,
                                   torch.float32, torch.float32],
                         [2, 2, 2, 2, 1, 1, 1]):
        loader.require(NAME, t, dt, nd)
    nq, L = queries.shape
    n, w = codes.shape
    card = lower.shape[0]
    if (q_paas.shape != (nq, w) or raw.shape != (n, L)
            or bound.shape != (nq,) or upper.shape != (card,)
            or not 1 <= w <= MAX_W or n >= 2 ** 31):
        raise ValueError(f"{NAME}: inconsistent shapes queries "
                         f"{tuple(queries.shape)} q_paas "
                         f"{tuple(q_paas.shape)} codes {tuple(codes.shape)} "
                         f"raw {tuple(raw.shape)} bound {tuple(bound.shape)}")
    if dead is not None:
        if dead.shape != (n,):
            raise ValueError(f"{NAME}: dead {tuple(dead.shape)} for {n} rows")
        # a bool mask (the executor's) is read as bytes without a copy
        dead = (dead if dead.dtype == torch.bool else dead != 0)
        dead = dead.contiguous().view(torch.uint8)
    if nq == 0 or n == 0:
        return (torch.full((nq, k), float("inf"), device=dev),
                torch.full((nq, k), -1, dtype=torch.int32, device=dev),
                torch.zeros(nq, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    plan = launch_plan(nq, n, L, w, k, card, _sms(dev.index))
    lib = loader.library()
    # the kernel writes every element of its outputs
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    counts = torch.empty(nq, dtype=torch.int32, device=dev)
    union = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = loader.stream_ptr(dev)
        ctr, lists = _workspace(dev, stream, nq, plan.lists)
        rc = lib.coconut_scan_verify(
            queries.data_ptr(), q_paas.data_ptr(), codes.data_ptr(),
            raw.data_ptr(), lower.data_ptr(), upper.data_ptr(),
            bound.data_ptr(), 0 if dead is None else dead.data_ptr(),
            ctr.data_ptr(), lists.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(),
            counts.data_ptr(), union.data_ptr(), nq, n, w, L, card, k,
            float(scale), plan.tile, plan.qchunk, plan.grid, plan.smem,
            _offsets_arg(plan.offsets), stream)
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return out_d, out_i, counts, union
