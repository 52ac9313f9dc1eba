"""Shared building blocks: RMSNorm, RoPE, gated MLP, initializers.

Params are plain dicts of tensors (a block's ``nn.ParameterDict`` passes
as one); every weight is created through ``dense_init`` from one explicit
``torch.Generator`` stream, so a model is a function of its seed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..launch.sharding import UNSHARDED, Shardings

__all__ = ["rms_norm", "rope", "gated_mlp", "gated_mlp_init", "dense_init",
           "Initializer", "softplus", "dtype_of", "dtype_anchor"]


def dtype_of(name: str) -> torch.dtype:
    """A config's ``param_dtype`` string as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown param_dtype {name!r}")
    return dt


class _Anchor(torch.autograd.Function):
    """Identity forward; the backward casts the cotangent to the primal's
    dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def dtype_anchor(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward casts the cotangent to the primal dtype.

    Placed at layer-group boundaries, as in the reference, it keeps an
    fp32 cotangent (from the fp32 loss, norm or router internals) from
    widening the backward activations of a bf16 model.  PyTorch's
    autograd engine already casts every gradient to its input's dtype;
    the anchor states the cast where the reference states it."""
    return _Anchor.apply(x)


class Initializer:
    """The rng stream every weight is drawn from: one ``torch.Generator``
    on the weights' device, seeded once; ``init.next()`` hands it out (the
    reference splits a key per weight; here the draws share one stream)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def next(self) -> torch.Generator:
        return self._gen


def dense_init(init: Optional[Initializer], shape: Tuple[int, ...], dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in initializer: N(0, 1) cut at +-2, times
    ``fan_in ** -0.5`` (``fan_in`` is ``shape[0]``) or ``scale``.  With
    no initializer the tensor is left empty, for weights loaded after."""
    if init is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0]
    if scale is None:
        scale = fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                generator=init.next())
    return (t * scale).to(dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)``, with no linear cut-off
    (``F.softplus`` returns ``x`` itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, scaled by ``1 + scale``, back in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the two halves of the head dimension (not
    interleaved pairs).  x: [B, T, H, D], positions: [B, T] or [T]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]          # [B, T, 1, half]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gated_mlp(x: torch.Tensor, p, sh: Shardings = UNSHARDED
              ) -> torch.Tensor:
    """SwiGLU feed-forward: silu(x W_g) * (x W_u) W_d, the silu in fp32."""
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    h = sh.act(h, "batch", "seq_unsharded", "mlp")
    return h @ p["w_down"]


def gated_mlp_init(init: Optional[Initializer], d: int, ff: int, dtype,
                   device) -> dict:
    return {
        "w_gate": dense_init(init, (d, ff), dtype, device),
        "w_up": dense_init(init, (d, ff), dtype, device),
        "w_down": dense_init(init, (ff, d), dtype, device),
    }
