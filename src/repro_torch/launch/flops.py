"""Analytic FLOP model per (arch x shape): the roofline compute term.

A compiled program's cost analysis counts each loop *body* once (layer
scans, microbatch accumulation), and an eager PyTorch step has no compiled
program at all, so the compute term uses an analytic model, the
reference's own, over the same ``ModelConfig``:

  * matmul work     = 2 x (active matmul params) per token
  * attention work  = 4 x H x hd x eff_ctx per token per attn layer
  * SSD work        = chunked intra (Q-tile) + inter-chunk state updates
  * train multiplier: fwd(1) + bwd(2) + remat re-fwd(1) = 4x forward
    (MODEL_FLOPS for the "useful ratio" stays the assignment's 6·N·D —
    remat and padding waste then shows up as ratio < 1).

All numbers are GLOBAL flops; the per-device share divides by chip count
(SPMD splits matmuls evenly; padding waste is already inside cfg's padded
dims).
"""
from __future__ import annotations

from typing import Optional

from ..models.config import ModelConfig

__all__ = ["forward_flops", "step_flops", "model_flops_6nd"]


def _matmul_params(cfg: ModelConfig) -> int:
    """Active parameters that participate in matmuls (embed gather excluded,
    unembed included)."""
    return cfg.active_param_count() - cfg.vocab * cfg.d_model


def _attn_layer_flops(cfg: ModelConfig, B: int, T: int, eff_ctx: float
                      ) -> float:
    """Scores + AV for one attention layer over B x T queries."""
    return 4.0 * B * T * cfg.n_heads * cfg.head_dim_ * eff_ctx


def _ssd_layer_flops(cfg: ModelConfig, B: int, T: int) -> float:
    """Chunked SSD: intra-chunk quadratic tile + inter-chunk state update."""
    H, P, S = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, max(T, 1))
    intra = 2.0 * B * T * Q * H * (P + S)        # CB^T tile + (CB' L) X tile
    inter = 4.0 * B * T * H * P * S / max(Q, 1)  # state inject + read-out
    state_io = 4.0 * B * T * H * P * S / max(Q, 1)
    return intra + inter + state_io


def forward_flops(cfg: ModelConfig, B: int, T: int, *,
                  decode_ctx: Optional[int] = None) -> float:
    """Global forward flops for a B x T pass (or a 1-token decode when
    ``decode_ctx`` is given: T must be 1 and eff_ctx = cache length)."""
    tokens = B * T
    total = 2.0 * tokens * _matmul_params(cfg)
    kinds = cfg.layer_kinds()
    for kind in kinds:
        if kind in ("attn", "moe"):
            if decode_ctx is not None:
                W = cfg.window if cfg.family == "hybrid" and cfg.window \
                    else decode_ctx
                eff = min(W, decode_ctx)
            elif cfg.family == "hybrid" and cfg.window:
                eff = min(cfg.window, T) / (1.0 if T > cfg.window else 2.0)
            else:
                eff = (T + 1) / 2.0           # causal average context
            total += _attn_layer_flops(cfg, B, T, eff)
        elif kind == "ssm":
            if decode_ctx is not None:
                H, P, S = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
                total += 6.0 * B * H * P * S   # single recurrence step
            else:
                total += _ssd_layer_flops(cfg, B, T)
        elif kind == "rec":
            r = cfg.rnn_width_
            total += 10.0 * tokens * r         # gates + recurrence (element)
    if cfg.is_encdec and decode_ctx is None:
        # encoder over the frontend frames
        Tf = cfg.frontend_tokens
        enc_tokens = B * Tf
        d, ff = cfg.d_model, cfg.d_ff
        hd, H, KV = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
        att_p = d * H * hd + 2 * d * KV * hd + H * hd * d
        total += 2.0 * enc_tokens * (att_p + 3 * d * ff)
        total += cfg.enc_layers * _attn_layer_flops(cfg, B, Tf, Tf)
        # decoder cross-attention reads the full memory
        total += cfg.n_layers * _attn_layer_flops(cfg, B, T, Tf)
    elif cfg.is_encdec:
        total += cfg.n_layers * _attn_layer_flops(
            cfg, B, 1, cfg.frontend_tokens)
    if cfg.frontend != "none" and not cfg.is_encdec and decode_ctx is None:
        # frontend tokens flow through the decoder stack too
        total *= (T + cfg.frontend_tokens) / max(T, 1)
    return total


def step_flops(cfg: ModelConfig, B: int, T: int, step: str, *,
               remat: bool = True) -> float:
    """Global flops for one executed step."""
    if step == "train":
        mult = 4.0 if remat else 3.0
        return mult * forward_flops(cfg, B, T)
    if step == "prefill":
        return forward_flops(cfg, B, T)
    if step == "decode":
        return forward_flops(cfg, B, 1, decode_ctx=T)
    raise ValueError(step)


def model_flops_6nd(cfg: ModelConfig, B: int, T: int, step: str) -> float:
    """The assignment's MODEL_FLOPS: 6·N_active·D train / 2·N·D inference."""
    tokens = B * (T if step != "decode" else 1)
    scale = 6.0 if step == "train" else 2.0
    return scale * cfg.active_param_count() * tokens
