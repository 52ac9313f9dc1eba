"""Wrapper of the ``fused_build`` CUDA kernel (``csrc/fused_build.cu``).

Raw ``[N, L]`` f32 -> (PAA ``[N, w]`` f32, SAX codes ``[N, w]`` uint8,
z-order keys ``[N, n_words]`` int64) in one pass.  Replaces the TPU kernel
``fused_build_pallas`` of the reference package.  A CPU tensor goes to the
plain twin :func:`repro_torch.kernels.ref.fused_build_ref`.  Its launch
plan is ``sax_summarize``'s (:func:`repro_torch.kernels.sax_summarize.
launch_plan`): the two kernels run one tile.
"""
from __future__ import annotations

import torch

from ..core.keys import n_key_words
from . import loader, ref
from .sax_summarize import launch_plan

__all__ = ["fused_build"]

NAME = "fused_build"


def fused_build(x: torch.Tensor, bps: torch.Tensor, *, segments: int,
                bits: int):
    """``bps``: the ``[2**bits - 1]`` ascending breakpoints."""
    if x.device.type == "cpu":
        return ref.fused_build_ref(x, bps, segments=segments, bits=bits)
    dev = loader.require_cuda(NAME, x, bps)
    loader.require(NAME, x, torch.float32, 2)
    loader.require(NAME, bps, torch.float32, 1)
    n, L = x.shape
    if (L % segments or not 1 <= bits <= 8
            or bps.shape[0] != (1 << bits) - 1):
        raise ValueError(f"{NAME}: x {tuple(x.shape)}, w={segments}, "
                         f"b={bits}, {bps.shape[0]} breakpoints")
    nw = n_key_words(segments, bits)
    paa = torch.empty((n, segments), dtype=torch.float32, device=dev)
    codes = torch.empty((n, segments), dtype=torch.uint8, device=dev)
    keys = torch.empty((n, nw), dtype=torch.int64, device=dev)
    if n == 0:
        return paa, codes, keys
    plan = launch_plan(n, segments)
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_fused_build(x.data_ptr(), bps.data_ptr(),
                                     paa.data_ptr(), codes.data_ptr(),
                                     keys.data_ptr(), n, L, segments, bits,
                                     nw, plan.grid, loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return paa, codes, keys
