"""Wrapper of the ``sax_summarize`` CUDA kernel (``csrc/sax_summarize.cu``).

Raw ``[N, L]`` f32 -> (PAA ``[N, w]`` f32, SAX codes ``[N, w]`` uint8), each
code the number of breakpoints <= its PAA value.  Replaces the TPU kernel
``sax_summarize_pallas`` of the reference package.  A CPU tensor goes to the
plain twin :func:`repro_torch.kernels.ref.sax_summarize_ref`.
"""
from __future__ import annotations

import torch

from . import loader, ref

__all__ = ["sax_summarize"]

NAME = "sax_summarize"
_THREADS = 256
_SMEM_FLOATS = 10240        # row tile budget: 40 KiB of shared memory


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
    # rows per block: enough (row, segment) pairs for the block's threads,
    # within the shared-memory budget (a row takes L + w floats)
    rows = max(1, min(max(1, _THREADS // segments),
                      _SMEM_FLOATS // (L + segments)))
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_sax_summarize(x.data_ptr(), bps.data_ptr(),
                                       paa.data_ptr(), codes.data_ptr(), n,
                                       L, segments, bits, rows,
                                       loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return paa, codes
