"""Wrapper of the ``scan_verify`` CUDA kernels (``csrc/scan_verify.cu``).

The fused SIMS scan: lower bound, live mask, ED of the live pairs, per-query
top-k, live counts and the union count, in one tile launch plus one merge
launch.  Replaces the TPU kernel ``scan_verify_pallas`` of the reference
package.  A CPU tensor goes to the plain twin
:func:`repro_torch.kernels.ref.scan_verify_ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import loader, ref

__all__ = ["scan_verify", "MAX_K"]

NAME = "scan_verify"
MAX_K = 64      # the top-k list lives in two registers per lane of a warp
MAX_W = 64


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
        dead = dead.to(torch.int32).contiguous()
        if dead.shape != (n,):
            raise ValueError(f"{NAME}: dead {tuple(dead.shape)} for {n} rows")
    out_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros(nq, dtype=torch.int32, device=dev)
    union = torch.zeros((), dtype=torch.int32, device=dev)
    if nq == 0 or n == 0:
        return out_d, out_i, counts, union
    lib = loader.library()
    tiles = lib.coconut_scan_verify_tiles_for(n)
    part_d = torch.empty((tiles, nq, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((tiles, nq, k), dtype=torch.int32, device=dev)
    flags = torch.zeros(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.coconut_scan_verify(
            queries.data_ptr(), q_paas.data_ptr(), codes.data_ptr(),
            raw.data_ptr(), lower.data_ptr(), upper.data_ptr(),
            bound.data_ptr(), 0 if dead is None else dead.data_ptr(),
            flags.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), counts.data_ptr(),
            union.data_ptr(), nq, n, w, L, card, k, float(scale),
            loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return out_d, out_i, counts, union
