"""Wrapper of the ``unpack_mindist`` CUDA kernel (``csrc/unpack_mindist.cu``).

Batched squared iSAX lower bound over bit-packed code rows: q_paas
``[Q, w]`` f32 x packed ``[N, ceil(w*b/8)]`` uint8 -> ``[Q, N]`` f32,
bit-equal to ``mindist_batch`` on the decoded codes.  Replaces the TPU
kernel ``unpack_mindist_batch_pallas`` of the reference package.  A CPU
tensor goes to the plain twin
:func:`repro_torch.kernels.ref.mindist_batch_packed_ref`.  The launch plan
is ``mindist_batch``'s (:func:`repro_torch.kernels.mindist_batch.launch_plan`):
at b = 8 a packed row is the code row and is read in place; at b < 8 a
block stages its packed rows.
"""
from __future__ import annotations

import torch

from . import loader, ref
from .mindist_batch import launch_plan

__all__ = ["unpack_mindist"]

NAME = "unpack_mindist"
MAX_W = 64


def unpack_mindist(q_paas: torch.Tensor, packed: torch.Tensor,
                   lower: torch.Tensor, upper: torch.Tensor, scale: float,
                   *, w: int, b: int) -> torch.Tensor:
    """``lower``/``upper``: the ``[2**b]`` region tables (+/-inf ends)."""
    if packed.device.type == "cpu":
        return ref.mindist_batch_packed_ref(q_paas, packed, lower, upper,
                                            scale, w=w, b=b)
    dev = loader.require_cuda(NAME, q_paas, packed, lower, upper)
    loader.require(NAME, q_paas, torch.float32, 2)
    loader.require(NAME, packed, torch.uint8, 2)
    loader.require(NAME, lower, torch.float32, 1)
    loader.require(NAME, upper, torch.float32, 1)
    nq = q_paas.shape[0]
    n, pw = packed.shape
    card = lower.shape[0]
    if (not 1 <= b <= 8 or q_paas.shape[1] != w or pw != -(-(w * b) // 8)
            or card != 1 << b or upper.shape[0] != card
            or not 1 <= w <= MAX_W):
        raise ValueError(f"{NAME}: q_paas {tuple(q_paas.shape)}, packed "
                         f"{tuple(packed.shape)}, tables {card}, w={w}, b={b}")
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if nq == 0 or n == 0:
        return out
    plan = launch_plan(nq, n, w)
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_unpack_mindist(
            q_paas.data_ptr(), packed.data_ptr(), lower.data_ptr(),
            upper.data_ptr(), out.data_ptr(), nq, n, w, b, pw, card,
            float(scale), plan.qt, *plan.grid, loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return out
