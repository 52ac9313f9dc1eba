"""The scan mesh: the ordered devices a device-resident sharded scan spans.

The reference lays the pinned ``[S, cap, ...]`` shard stacks over a 1-D
``jax.sharding.Mesh`` and runs one ``shard_map`` program over it.  Here
the mesh is an ordered tuple of ``torch.device``: device ``j`` holds the
``S / D`` contiguous sub-shards ``j * S/D .. (j+1) * S/D - 1`` and runs
their launches; the per-device ``[Q, k]`` lists are gathered to the first
device, which selects.  That is the one-process counterpart of
``shard_map`` with an ``all_gather`` merge, so the reference's
``distributed/compat.py`` (its ``shard_map`` shim) has no counterpart.

A pipeline's mesh (``distributed/pipeline.py``) is the same kind of tuple
with one entry a stage: :func:`make_stage_mesh`.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["SCAN_AXIS", "make_scan_mesh", "make_stage_mesh"]

# the name of the mesh's one axis: the shard axis of the pinned stacks
SCAN_AXIS = "shard"


def make_scan_mesh(n_shards: int, *,
                   devices: Optional[Sequence] = None
                   ) -> Tuple[torch.device, ...]:
    """The devices the scan of ``n_shards`` spans: D of ``devices`` (every
    visible CUDA device by default), D the largest divisor of ``n_shards``
    that fits, so the stacks always split evenly (with one device every
    shard count is a single-device launch).  ``COCONUT_MESH_DEVICES``
    caps D below the device count (a knob for device-scaling sweeps)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass the scan "
                               "mesh's devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    cap = int(os.environ.get("COCONUT_MESH_DEVICES", "0") or 0)
    if cap > 0:
        devices = devices[:cap]
    if not devices:
        raise ValueError("the scan mesh needs at least one device")
    d = max(x for x in range(1, min(n_shards, len(devices)) + 1)
            if n_shards % x == 0)
    return tuple(devices[:d])


def make_stage_mesh(n_stages: int, *,
                    devices: Optional[Sequence] = None
                    ) -> Tuple[torch.device, ...]:
    """One device a pipeline stage: ``n_stages`` entries over ``devices``
    (every visible CUDA device by default) in contiguous runs, stage s on
    device ``s * D // n_stages``; on one card every stage is ``cuda:0``."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass the "
                               "pipeline's devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a stage mesh needs at least one device")
    D = len(devices)
    return tuple(devices[s * D // n_stages] for s in range(n_stages))
