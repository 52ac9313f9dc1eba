"""Wrapper of the ``pool_merge`` CUDA kernel (``csrc/pool_merge.cu``).

Folds one leaf group's candidates into the per-query ``[Q, k]`` pools that
the exact scan keeps on the card (:class:`repro_torch.query.merger.
DeviceKnnPool`), in place, under :func:`repro_torch.query.merger.
merge_topk`'s contract, and accumulates what the group touched.  Replaces
no TPU kernel: the reference merges on the host.  A CPU tensor goes to the
plain twin :func:`repro_torch.kernels.ref.pool_merge_ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import loader, ref

__all__ = ["pool_merge", "MAX_K"]

NAME = "pool_merge"
MAX_K = 256              # pool entries a query holds: kMaxK in C


def pool_merge(md: torch.Tensor, dd: torch.Tensor, leaves: torch.Tensor,
               leaf: int, dead: Optional[torch.Tensor], ids: torch.Tensor,
               best_d: torch.Tensor, best_off: torch.Tensor,
               ext: torch.Tensor, counts: torch.Tensor,
               row_mark: torch.Tensor, leaf_mark: torch.Tensor) -> None:
    """``md``/``dd`` ``[Q, B]`` f32: the group's bound and cross ED; row
    ``j`` of the group is row ``j % leaf`` of leaf ``leaves[j // leaf]``
    (int64); ``dead`` ``[n]`` bool/uint8 or None and ``ids`` ``[n]`` int64
    over the partition's rows; ``best_d`` ``[Q, k]`` f32, ``best_off``
    ``[Q, k]`` int64 and ``ext`` ``[Q]`` f32 the pools; ``counts`` ``[Q]``
    int64, ``row_mark`` ``[>= n]`` uint8 and ``leaf_mark`` ``[Q,
    n_leaves]`` uint8 the accumulators.  Updates the pools and the
    accumulators in place."""
    if md.device.type == "cpu":
        ref.pool_merge_ref(md, dd, leaves, leaf, dead, ids, best_d,
                           best_off, ext, counts, row_mark, leaf_mark)
        return
    dev = loader.require_cuda(NAME, md, dd, leaves, ids, best_d, best_off,
                              ext, counts, row_mark, leaf_mark)
    loader.require(NAME, md, torch.float32, 2)
    loader.require(NAME, dd, torch.float32, 2)
    loader.require(NAME, leaves, torch.int64, 1)
    loader.require(NAME, ids, torch.int64, 1)
    loader.require(NAME, best_d, torch.float32, 2)
    loader.require(NAME, best_off, torch.int64, 2)
    loader.require(NAME, ext, torch.float32, 1)
    loader.require(NAME, counts, torch.int64, 1)
    loader.require(NAME, row_mark, torch.uint8, 1)
    loader.require(NAME, leaf_mark, torch.uint8, 2)
    nq, b = md.shape
    k = best_d.shape[1]
    n_leaves = leaf_mark.shape[1]
    if (dd.shape != md.shape or best_off.shape != best_d.shape
            or best_d.shape[0] != nq or ext.shape[0] != nq
            or counts.shape[0] != nq or leaf_mark.shape[0] != nq
            or not 1 <= k <= MAX_K or not 1 <= b < 2 ** 31 - MAX_K
            or leaf < 1 or leaves.shape[0] < -(-b // leaf) or n_leaves < 1):
        raise ValueError(f"{NAME}: md {tuple(md.shape)}, dd "
                         f"{tuple(dd.shape)}, pools {tuple(best_d.shape)}, "
                         f"{leaves.shape[0]} leaves of {leaf}; k <= {MAX_K}")
    if dead is not None:
        if dead.device != dev or dead.ndim != 1 or not dead.is_contiguous() \
                or dead.dtype not in (torch.bool, torch.uint8) \
                or dead.shape[0] != ids.shape[0]:
            raise ValueError(f"{NAME}: dead mask {dead.dtype} "
                             f"{tuple(dead.shape)} on {dead.device}")
    lib = loader.library()
    with torch.cuda.device(dev):
        rc = lib.coconut_pool_merge(
            md.data_ptr(), dd.data_ptr(), leaves.data_ptr(),
            None if dead is None else dead.data_ptr(), ids.data_ptr(),
            best_d.data_ptr(), best_off.data_ptr(), ext.data_ptr(),
            counts.data_ptr(), row_mark.data_ptr(), leaf_mark.data_ptr(),
            nq, b, leaf, k, n_leaves, loader.stream_ptr(dev))
    loader.LAUNCHES[NAME] += 1
    loader.check(NAME, rc)
