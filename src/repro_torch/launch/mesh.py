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

The pod meshes are ``torch.distributed`` ``DeviceMesh``es: one rank a
device, over a process group the caller has initialized (NCCL on cards,
gloo on the CPU, the fake backend for a dry run; nothing here starts
one).  Single pod: ``(data=16, model=16)``, 256 ranks; multi-pod: ``(pod=2,
data=16, model=16)``, 512 ranks, the ``pod`` axis carrying data
parallelism and FSDP.  A DTensor placement shards over them
(``launch/sharding.py``).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["SCAN_AXIS", "make_scan_mesh", "make_stage_mesh",
           "make_production_mesh", "make_host_mesh", "dp_axes", "fsdp_axes",
           "tp_axis"]

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


def _pod_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str):
    """A ``DeviceMesh`` of ``shape`` over ranks ``0 .. n-1`` of the
    initialized process group: the whole group, or its leading sub-grid
    when it has more ranks (the single-pod mesh inside a 512-rank dry
    run).  Fewer ranks than the mesh needs is an error."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs an initialized process group of {n} ranks "
            f"(init_process_group; the fake backend for a dry run)")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {world} — initialize "
            f"the process group with world_size={n}")
    if world == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """``(data=16, model=16)``, or ``(pod=2, data=16, model=16)`` with
    ``multi_pod``, over the initialized process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _pod_mesh(shape, axes, device_type)


def make_host_mesh(*, device_type: Optional[str] = None):
    """Degenerate ``(data=1, model=1)`` mesh for one-device runs of the
    sharded code: every placement falls to ``Replicate``.  On the card
    unless ``device_type="cpu"`` is asked for (without CUDA and no such
    request this raises)."""
    from ..core.tree import _device_for
    return _pod_mesh((1, 1), ("data", "model"),
                     _device_for(None, device_type).type)


def dp_axes(mesh) -> tuple:
    """Axes carrying data parallelism (batch sharding)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def fsdp_axes(mesh) -> tuple:
    """Axes over which parameters/optimizer state are fully sharded."""
    return dp_axes(mesh)


def tp_axis(mesh) -> str:
    return "model"
