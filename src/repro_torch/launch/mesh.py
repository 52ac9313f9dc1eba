"""The scan mesh: the ordered devices a device-resident sharded scan spans.

The reference lays the pinned ``[S, cap, ...]`` shard stacks over a 1-D
``jax.sharding.Mesh`` and runs one ``shard_map`` program over it.  Here
the mesh is an ordered tuple of ``torch.device``: device ``j`` holds the
``S / D`` contiguous sub-shards ``j * S/D .. (j+1) * S/D - 1`` and runs
their launches; the per-device ``[Q, k]`` lists are gathered to the first
device, which selects.  That is the one-process counterpart of
``shard_map`` with an ``all_gather`` merge, so the reference's
``distributed/compat.py`` (its ``shard_map`` shim) has no counterpart.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["SCAN_AXIS", "make_scan_mesh"]

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
