"""Wrapper of the ``batch_euclid`` CUDA kernels (``csrc/batch_euclid.cu``).

Squared ED as a direct diff-square-sum, in two forms: the cross form
``[Q, L] x [N, L] -> [Q, N]`` and the gathered form
``out[q, c] = ED(queries[q], series[idx[q, c]])``.  Replaces the TPU kernel
``batch_euclid_pallas`` of the reference package (its Q = 1 case).  CPU
tensors go to the plain twins in :mod:`repro_torch.kernels.ref`, which sum
in the kernels' order.
"""
from __future__ import annotations

import torch

from . import loader, ref

__all__ = ["batch_euclid", "batch_euclid_gather"]

NAME = "batch_euclid"
GATHER = "batch_euclid_gather"      # launch counter of the gathered form


def _check_queries(queries: torch.Tensor, series: torch.Tensor) -> None:
    loader.require(NAME, queries, torch.float32, 2)
    loader.require(NAME, series, torch.float32, 2)
    if queries.shape[1] != series.shape[1]:
        raise ValueError(f"{NAME}: queries {tuple(queries.shape)} vs series "
                         f"{tuple(series.shape)}")


def batch_euclid(queries: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """Cross form: queries ``[Q, L]``, series ``[N, L]`` -> ``[Q, N]``."""
    if series.device.type == "cpu":
        return ref.batch_euclid_ref(queries, series)
    dev = loader.require_cuda(NAME, queries, series)
    _check_queries(queries, series)
    nq, L = queries.shape
    n = series.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if nq == 0 or n == 0 or L == 0:
        return out.zero_()
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_euclid_cross(queries.data_ptr(), series.data_ptr(),
                                      out.data_ptr(), nq, n, L,
                                      loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
    return out


def batch_euclid_gather(queries: torch.Tensor, series: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """Gathered form: queries ``[Q, L]``, series ``[M, L]``, idx ``[Q, C]``
    int64 row numbers in ``[0, M)`` -> ``[Q, C]``."""
    if series.device.type == "cpu":
        return ref.batch_euclid_gather_ref(queries, series, idx)
    dev = loader.require_cuda(NAME, queries, series, idx)
    _check_queries(queries, series)
    loader.require(NAME, idx, torch.int64, 2)
    nq, L = queries.shape
    if idx.shape[0] != nq:
        raise ValueError(f"{NAME}: idx {tuple(idx.shape)} for {nq} queries")
    c = idx.shape[1]
    out = torch.empty((nq, c), dtype=torch.float32, device=dev)
    if nq == 0 or c == 0 or L == 0:
        return out.zero_()
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_euclid_gather(queries.data_ptr(), series.data_ptr(),
                                       idx.data_ptr(), out.data_ptr(), nq, c,
                                       L, loader.stream_ptr(dev))
    loader.LAUNCHES[GATHER] += 1
    loader.check(GATHER, rc)
    return out
