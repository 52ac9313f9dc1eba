"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)             (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)             (input gate)
    a_t = a ** (c * r_t) ,  a = sigmoid(Lambda),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the linear recurrence as a log-depth scan in fp32; decode is
a single O(1) update.  The surrounding residual block follows Griffin: a
gated branch (GeLU in its tanh form, the reference's default) multiplied
into the conv + RG-LRU branch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..launch.sharding import UNSHARDED, Shardings
from .config import ModelConfig
from .layers import Initializer, dense_init, softplus

__all__ = ["rglru_params", "rglru_block", "rglru_decode_step"]

_C = 8.0


def rglru_params(init: Optional[Initializer], cfg: ModelConfig, dtype,
                 device) -> dict:
    d, r = cfg.d_model, cfg.rnn_width_
    f32 = torch.float32
    return {
        "w_in_x": dense_init(init, (d, r), dtype, device),
        "w_in_y": dense_init(init, (d, r), dtype, device),
        "conv_w": dense_init(init, (cfg.conv_width, r), dtype, device,
                             scale=cfg.conv_width ** -0.5),
        "conv_b": torch.zeros((r,), dtype=dtype, device=device),
        "w_a": dense_init(init, (r, r), f32, device, scale=0.02),
        "b_a": torch.zeros((r,), dtype=f32, device=device),
        "w_x": dense_init(init, (r, r), f32, device, scale=0.02),
        "b_x": torch.zeros((r,), dtype=f32, device=device),
        # Lambda init so that a = sigmoid(Lambda) in (0.9, 0.999)
        "Lambda": torch.full((r,), 4.0, dtype=f32, device=device),
        "w_out": dense_init(init, (r, d), dtype, device),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _gates(xr: torch.Tensor, p, sh: Shardings = UNSHARDED):
    """xr: [B, T, r] (fp32) -> (a_t, gated_input), both fp32.  Under
    ``sh`` the gate matmuls take ``xr`` whole over the rnn width (they
    contract it), their outputs sharded over it like ``xr``."""
    xg = sh.act(xr, "batch", "seq_unsharded", None)
    r_gate = torch.sigmoid(xg @ p["w_a"] + p["b_a"])
    i_gate = torch.sigmoid(xg @ p["w_x"] + p["b_x"])
    # a_t = sigmoid(Lambda)^(c * r_t); log sigmoid(L) = -softplus(-L)
    log_a = _C * r_gate * (-softplus(-p["Lambda"]))
    a_t = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a_t ** 2, min=1e-12)) \
        * (i_gate * xr)
    return a_t, gated


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, in
    ceil(log2 T) steps: each step composes every element with the one
    ``shift`` before it, (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    T = a.shape[1]
    shift = 1
    while shift < T:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def _rglru_scan(xr: torch.Tensor, p, h0: Optional[torch.Tensor] = None,
                sh: Shardings = UNSHARDED):
    """The recurrence over a sequence.  xr: [B, T, r] fp32.  A carried
    state ``h0`` is folded into step 0's additive term."""
    a_t, b_t = _gates(xr, p, sh)
    if h0 is not None:
        b_t = torch.cat([b_t[:, :1] + (a_t[:, 0] * h0)[:, None],
                         b_t[:, 1:]], dim=1)
    h = _linear_scan(a_t, b_t)
    return h, h[:, -1]


def rglru_block(x: torch.Tensor, p, cfg: ModelConfig,
                sh: Shardings = UNSHARDED
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Griffin recurrent block over a full sequence.  x: [B, T, d]."""
    B, T, _ = x.shape
    K = cfg.conv_width
    y_branch = _gelu((x @ p["w_in_y"]).float())
    xb = x @ p["w_in_x"]
    xb = sh.act(xb, "batch", "seq_unsharded", "rnn")
    # causal depthwise conv
    xp = torch.cat([xb.new_zeros((B, K - 1, xb.shape[2])), xb], dim=1)
    xc = sum(xp[:, i: i + T] * p["conv_w"][i][None, None, :]
             for i in range(K)) + p["conv_b"]
    new_conv_state = xp[:, -(K - 1):] if K > 1 else None
    h, last_h = _rglru_scan(xc.float(), p, sh=sh)
    out = (h * y_branch).to(x.dtype)
    return out @ p["w_out"], (new_conv_state, last_h)


def rglru_decode_step(x: torch.Tensor, p, cfg: ModelConfig, *,
                      conv_state: torch.Tensor, rnn_state: torch.Tensor):
    """One-token decode.  x: [B, 1, d]."""
    y_branch = _gelu((x @ p["w_in_y"]).float())
    xb = x @ p["w_in_x"]                                       # [B, 1, r]
    window = torch.cat([conv_state.to(xb.dtype), xb], dim=1)
    xc = torch.einsum("bkr,kr->br", window, p["conv_w"]) + p["conv_b"]
    new_conv_state = window[:, 1:]
    a_t, b_t = _gates(xc[:, None].float(), p)
    h = a_t[:, 0] * rnn_state + b_t[:, 0]
    out = (h[:, None] * y_branch).to(x.dtype)
    return out @ p["w_out"], (new_conv_state, h)
