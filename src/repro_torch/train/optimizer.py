"""AdamW with mixed-precision semantics, the reference's own arithmetic.

Parameters may live in bf16; the first and second moments are stored in
``moment_dtype`` (fp32 unless a config asks for bf16) and the update math
runs in fp32 and is cast back to the parameter's dtype ("masterless"
mixed precision).  This is not ``torch.optim.AdamW``: weight decay is
applied as ``p - lr * (delta + wd * p)`` to every leaf, gradients are
clipped by their global norm, and the learning rate comes from an fp32
step counter.

A tree here is a flat ``{name: tensor}`` dict, as ``init_train_state``
makes it from the model's parameter names.  The update writes the new
parameters and moments into the given tensors in place (the reference's
jitted step with its buffers donated): nothing of the size of the state is
allocated twice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

__all__ = ["AdamWConfig", "schedule", "adamw_init", "global_norm",
           "adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # moment storage dtype: "bfloat16" halves optimizer-state memory for
    # the largest archs (the update math still runs in fp32)
    moment_dtype: str = "float32"


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``, in fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: Dict[str, torch.Tensor],
               moment_dtype: str = "float32") -> dict:
    """Zero moments beside each parameter, and the step counter (int32)."""
    dt = getattr(torch, moment_dtype)
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt`` of the sum of every leaf's fp32 sum of squares.

    The leaves are summed in the dict's order: for a state that
    ``init_train_state`` made, the model's parameter order (embedding,
    unembedding, final norm, adapter, then layer by layer, the encoder
    last).  The reference sums its stacked leaves in sorted key order, so
    the two sums differ in their last bits, not in their terms."""
    return torch.sqrt(sum(torch.sum(leaf.to(torch.float32) ** 2)
                          for leaf in tree.values()))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root, as XLA's.  CUDA's ``sqrtf``
    is; PyTorch's vectorized CPU kernel is off by an ulp now and then, so
    on the CPU the root is taken in fp64 and rounded once (exact: fp64
    holds more than twice fp32's digits)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], opt: dict,
                 cfg: AdamWConfig) -> Tuple[dict, dict, dict]:
    """One AdamW step.  Returns (params, opt, metrics); ``params`` and the
    moments are the given tensors, updated in place."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1 - b1 ** stepf
    c2 = 1 - b2 ** stepf
    for k, p in params.items():
        m, v = opt["m"][k], opt["v"][k]
        g = grads[k].to(torch.float32) * clip
        m2 = b1 * m.to(torch.float32) + (1 - b1) * g
        v2 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mhat = m2 / c1
        vhat = v2 / c2
        delta = mhat / (_sqrt(vhat) + cfg.eps)
        p32 = p.to(torch.float32)
        p2 = p32 - lr * (delta + cfg.weight_decay * p32)
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
    opt["step"] = step
    return params, opt, {"grad_norm": gnorm, "lr": lr}
