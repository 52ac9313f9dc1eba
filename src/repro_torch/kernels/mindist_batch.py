"""Wrapper of the ``mindist_batch`` CUDA kernel (``csrc/mindist_batch.cu``).

Batched squared iSAX lower bound: q_paas ``[Q, w]`` f32 x codes ``[N, w]``
uint8 -> ``[Q, N]`` f32.  Replaces the TPU kernels ``mindist_batch_pallas``
and (at Q = 1) ``mindist_pallas`` of the reference package.  A CPU tensor
goes to the plain twin :func:`repro_torch.kernels.ref.mindist_batch_ref`.
"""
from __future__ import annotations

import torch

from . import loader, ref

__all__ = ["mindist_batch"]

NAME = "mindist_batch"
MAX_W = 64


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
    if codes.shape[1] != w or upper.shape[0] != card or not 1 <= w <= MAX_W:
        raise ValueError(f"{NAME}: q_paas {tuple(q_paas.shape)}, codes "
                         f"{tuple(codes.shape)}, tables {card}; w <= {MAX_W}")
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if nq == 0 or n == 0:
        return out
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_mindist_batch(
            q_paas.data_ptr(), codes.data_ptr(), lower.data_ptr(),
            upper.data_ptr(), out.data_ptr(), nq, n, w, card, float(scale),
            loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return out
