"""Wrapper of the ``zorder`` CUDA kernel (``csrc/zorder.cu``).

SAX codes ``[N, w]`` uint8 -> z-order keys ``[N, n_words]`` int64 (32-bit
words, the port's key layout).  Replaces the TPU kernel ``zorder_pallas`` of
the reference package.  A CPU tensor goes to the plain twin
:func:`repro_torch.kernels.ref.zorder_ref`.
"""
from __future__ import annotations

import torch

from ..core.keys import n_key_words
from . import loader, ref

__all__ = ["zorder"]

NAME = "zorder"
MAX_W = 64


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
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_zorder(codes.data_ptr(), keys.data_ptr(), n, w, b,
                                nw, loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return keys
