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
parallelism and FSDP.  :func:`make_pod_mesh` lays a mesh with ``pod``
and ``data`` out with the two as one dim, ``"pod+data"`` (ranks in the
same major-to-minor order as the reference's ``PartitionSpec(('pod',
'data'), ...)``): every rule names the two together, so each sharding
over them is one collective over one group rather than two in turn, and
DTensor's search for an op's placements runs over two mesh dims, not
three (over three it took over a minute for one matmul of a backward).
A DTensor placement shards over its dims (``launch/sharding.py``).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["SCAN_AXIS", "make_scan_mesh", "make_stage_mesh",
           "make_pod_mesh", "make_production_mesh", "make_host_mesh",
           "pod_dims", "dim_axes", "dp_axes", "fsdp_axes", "tp_axis"]

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


# a mesh dim's name joins the pod axes it covers
FLAT = "+"


def pod_dims(shape: Tuple[int, ...], axes: Tuple[str, ...]
             ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The dims a pod mesh of ``shape`` over ``axes`` is laid out by:
    ``'pod'`` and ``'data'`` (adjacent, in that order) as one dim
    ``"pod+data"`` of their product's size, its index ``pod * data_size +
    data``; every other axis its own dim."""
    if "pod" not in axes:
        return tuple(shape), tuple(axes)
    i = axes.index("pod")
    assert axes[i + 1:i + 2] == ("data",), f"'pod' without 'data' in {axes}"
    return (shape[:i] + (shape[i] * shape[i + 1],) + shape[i + 2:],
            axes[:i] + (FLAT.join(axes[i:i + 2]),) + axes[i + 2:])


def make_pod_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                  device_type: str):
    """A ``DeviceMesh`` of ``shape`` over the pod ``axes``, laid out by
    :func:`pod_dims`, over ranks ``0 .. n-1`` of the initialized process
    group: the whole group, or its leading sub-grid when it has more ranks
    (the single-pod mesh inside a 512-rank dry run).  Fewer ranks than the
    mesh needs is an error."""
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
    dims, names = pod_dims(tuple(shape), tuple(axes))
    if world == n:
        return init_device_mesh(device_type, dims, mesh_dim_names=names)
    return DeviceMesh(device_type, torch.arange(n).reshape(dims),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """``(data=16, model=16)``, or ``(pod=2, data=16, model=16)`` with
    ``multi_pod`` (a ``(32, 16)`` mesh, ``("pod+data", "model")``), over
    the initialized process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_pod_mesh(shape, axes, device_type)


def make_host_mesh(*, device_type: Optional[str] = None):
    """Degenerate ``(data=1, model=1)`` mesh for one-device runs of the
    sharded code: every placement falls to ``Replicate``.  On the card
    unless ``device_type="cpu"`` is asked for (without CUDA and no such
    request this raises)."""
    from ..core.tree import _device_for
    return make_pod_mesh((1, 1), ("data", "model"),
                         _device_for(None, device_type).type)


def dim_axes(mesh) -> Tuple[Tuple[str, ...], ...]:
    """The pod axes each dim of ``mesh`` covers, in mesh order: one a dim,
    ``('pod', 'data')`` for the flattened dim.  A mesh with ``'pod'`` and
    ``'data'`` as dims of their own is refused: :func:`make_pod_mesh`
    lays them out as one."""
    names = tuple(mesh.mesh_dim_names)
    if {"pod", "data"} <= set(names):
        raise ValueError(f"'pod' and 'data' are separate dims of {names}: "
                         f"make the mesh with make_pod_mesh, which lays "
                         f"them out as one")
    return tuple(tuple(n.split(FLAT)) for n in names)


def dp_axes(mesh) -> tuple:
    """Axes carrying data parallelism (batch sharding)."""
    axes = {a for dim in dim_axes(mesh) for a in dim}
    return tuple(a for a in ("pod", "data") if a in axes)


def fsdp_axes(mesh) -> tuple:
    """Axes over which parameters/optimizer state are fully sharded."""
    return dp_axes(mesh)


def tp_axis(mesh) -> str:
    return "model"
