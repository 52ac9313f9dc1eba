"""GPipe-style pipeline parallelism over an ordered tuple of devices.

Each stage owns a contiguous slice of layers; microbatches stream through
the pipeline with activation handoffs.  The schedule is the classic GPipe
loop of ``M + S - 1`` ticks (M microbatches, S stages): stage s computes
microbatch m at tick m + s.  The reference runs one ``shard_map`` program
over a mesh axis, with ``ppermute`` handoffs and zero work in the bubbles;
here the mesh is ``launch/mesh.py``'s ordered device tuple (one entry a
stage, :func:`make_stage_mesh`), stage s's parameters live on device s,
an activation moves to the next stage's device with ``.to()``, and a
bubble does no work.  Launches on different devices run concurrently,
since the host only enqueues them; on one card the tuple repeats
``cuda:0`` and the stages run in turn.

This is the *forward* pipeline as a composable transform over any
per-stage function.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["pipeline_forward"]


def _stage_slice(tree, s: int, device):
    """Row ``s`` of every tensor of a (nested dict) tree, on ``device``."""
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s, device) for k, v in tree.items()}
    return tree[s].to(device)


def pipeline_forward(mesh: Sequence, stage_fn: Callable, n_stages: int):
    """Build a pipelined forward: x [M, B, ...] -> y [M, B, ...].

    ``stage_fn(stage_params, x) -> x`` applies one stage's layers.
    ``stage_params`` is stacked on dim 0 (row s is stage s's, as the
    reference shards it over the axis); ``mesh`` holds one device a stage.
    Microbatch m enters stage 0 at tick m and leaves stage S-1 at tick
    m + S - 1; only the last stage's outputs are kept, and they are
    returned on its device.
    """
    S = n_stages
    devices = tuple(torch.device(d) for d in mesh)
    if len(devices) != S:
        raise ValueError(f"{S} stages need a mesh of {S} devices, got "
                         f"{len(devices)}")

    def call(stage_params, xs: torch.Tensor) -> torch.Tensor:
        params = [_stage_slice(stage_params, s, devices[s])
                  for s in range(S)]
        M = xs.shape[0]
        waiting = [None] * S           # the activation at each stage's door
        outs = [None] * M
        for t in range(M + S - 1):
            if t < M:                  # stage 0 takes microbatch t
                waiting[0] = xs[t].to(devices[0])
            arrived = [None] * S
            for s in range(S):
                if waiting[s] is None:
                    continue           # a bubble
                y = stage_fn(params[s], waiting[s])
                if s == S - 1:
                    outs[t - (S - 1)] = y
                else:
                    arrived[s + 1] = y.to(devices[s + 1])
            waiting = arrived
        return torch.stack(outs)

    return call
