"""Mamba-2 (SSD, state-space duality) block: chunked prefill and O(1)
decode.

The SSD algorithm (Dao & Gu, arXiv:2405.21060) computes the selective
state-space recurrence

    s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * B_t x_t ,   y_t = C_t s_t + D x_t

in chunks: quadratic attention-like math *within* a chunk and a linear
pass over per-chunk states *between* chunks (a Python loop over chunks
here, the reference's ``lax.scan``), all in fp32.  Decode is a single
recurrence step on the [B, H, P, S] state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..launch.sharding import UNSHARDED, Shardings
from .config import ModelConfig
from .layers import Initializer, dense_init, rms_norm, softplus

__all__ = ["ssm_params", "ssm_block", "ssm_decode_step"]


def ssm_params(init: Optional[Initializer], cfg: ModelConfig, dtype,
               device) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    S, G, H = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    conv_ch = di + 2 * G * S
    f32 = torch.float32
    return {
        "in_proj": dense_init(init, (d, 2 * di + 2 * G * S + H), dtype,
                              device),
        "conv_w": dense_init(init, (cfg.conv_width, conv_ch), dtype, device,
                             scale=cfg.conv_width ** -0.5),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), dtype=f32, device=device),
        "D": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "norm": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": dense_init(init, (di, d), dtype, device),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, S, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di: 2 * di]
    Bm = zxbcdt[..., 2 * di: 2 * di + G * S]
    Cm = zxbcdt[..., 2 * di + G * S: 2 * di + 2 * G * S]
    dt = zxbcdt[..., 2 * di + 2 * G * S:]
    return z, x, Bm, Cm, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv over time, then silu.  x: [B, T, C]; w: [K, C].

    Returns (y, new_state) where state is the last K-1 inputs (for decode).
    """
    K, T = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[2])), x], dim=1)
    y = sum(xp[:, i: i + T] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu((y + b).float()).to(x.dtype), new_state


def _ssd_chunked(x, dt, A, Bm, Cm, cfg: ModelConfig,
                 init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x:  [B, T, H, P]   (P = ssm_head_dim)
    dt: [B, T, H]      (already softplus'd, positive)
    A:  [H]            (negative)
    Bm, Cm: [B, T, G, S] broadcast over heads within a group.
    Returns (y [B, T, H, P], final_state [B, H, P, S]).  T need not be a
    multiple of the chunk: the tail chunk is zero-padded (dt = 0 there,
    so the padding neither decays nor feeds the state).
    """
    B, T, H, P = x.shape
    G, S = Bm.shape[2], Bm.shape[3]
    Q = min(cfg.ssm_chunk, T)
    nc = -(-T // Q)
    Tp = nc * Q
    pad = Tp - T

    def padded(t):
        if not pad:
            return t
        z = t.new_zeros((B, pad) + tuple(t.shape[2:]))
        return torch.cat([t, z], dim=1)

    x, dt, Bm, Cm = padded(x), padded(dt), padded(Bm), padded(Cm)
    rep = H // G
    f32 = torch.float32
    xb = x.reshape(B, nc, Q, H, P).float()
    dtb = dt.reshape(B, nc, Q, H).float()
    Bb = torch.repeat_interleave(Bm.reshape(B, nc, Q, G, S), rep,
                                 dim=3).float()              # [B,nc,Q,H,S]
    Cb = torch.repeat_interleave(Cm.reshape(B, nc, Q, G, S), rep,
                                 dim=3).float()
    da = dtb * A[None, None, None, :]                          # [B,nc,Q,H]
    cum = torch.cumsum(da, dim=2)                              # within chunk
    li = torch.tril(torch.ones((Q, Q), dtype=f32,
                               device=x.device))[None, :, :, None]

    state = (torch.zeros((B, H, P, S), dtype=f32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq, cumq = (xb[:, c], dtb[:, c], Bb[:, c], Cb[:, c],
                                 cum[:, c])
        # decay from token l to the end of the chunk / from its start to l
        seg_end = torch.exp(cumq[:, -1:, :] - cumq)            # [B,Q,H]
        seg_start = torch.exp(cumq)                            # [B,Q,H]
        # intra-chunk (attention-like) term:
        # L[l, m] = exp(cum_l - cum_m) for m <= l
        rel = cumq[:, :, None, :] - cumq[:, None, :, :]        # [B,Q,Q,H]
        Lmat = torch.where(li > 0, torch.exp(rel), 0.0)
        # the products run left to right, a pair at a time (as einsum does
        # without opt_einsum, whose paths can form [B, H, Q, P, S] outer
        # products that the backward keeps for every chunk)
        sc = torch.einsum("blhs,bmhs->blmh", cq, bq)           # C_l . B_m
        w = sc * Lmat * dtq[:, None]                           # [B,Q,Q,H]
        y_diag = torch.einsum("blmh,bmhp->blhp", w, xq)
        # contribution of the carried state
        y_off = torch.einsum("blhs,bhps->blhp", cq, state) \
            * seg_start[..., None]
        # state update: decay the old state over the chunk + the chunk's
        chunk_decay = torch.exp(cumq[:, -1, :])                # [B,H]
        u = bq * seg_end[..., None] * dtq[..., None]           # [B,Q,H,S]
        state = state * chunk_decay[:, :, None, None] + torch.einsum(
            "blhs,blhp->bhps", u, xq)
        ys.append((y_diag + y_off).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(B, Tp, H, P)[:, :T]
    return y, state


def ssm_block(x: torch.Tensor, p, cfg: ModelConfig,
              sh: Shardings = UNSHARDED
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence Mamba-2 block.  x: [B, T, d] -> [B, T, d].

    Returns (y, (conv_state, ssm_state)) so prefill can seed decode.
    """
    B, T, d = x.shape
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    G, S = cfg.ssm_groups, cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    z, xs, Bm, Cm, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, new_conv_state = _causal_conv(conv_in, p["conv_w"],
                                            p["conv_b"])
    xs = conv_out[..., :di].reshape(B, T, H, P)
    Bm = conv_out[..., di: di + G * S].reshape(B, T, G, S)
    Cm = conv_out[..., di + G * S:].reshape(B, T, G, S)
    xs = sh.act(xs, "batch", "seq_unsharded", "heads", None)
    dt = softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    # the scan is independent per (batch row, head): it runs on the local
    # shards, B and C repeated to the heads first (a local head then finds
    # its group's row at its own index; the scan's own repeat is then a
    # copy, and the values are the same)
    Bh = torch.repeat_interleave(Bm, H // G, dim=2)
    Ch = torch.repeat_interleave(Cm, H // G, dim=2)
    px = sh.placements(xs.shape, "batch", "seq_unsharded", "heads", None)
    pt = sh.placements(dt.shape, "batch", "seq_unsharded", "heads")
    pa = sh.placements(A.shape, "heads")
    ps = sh.placements((B, H, P, S), "batch", "heads", None, None)
    y, final_state = sh.local(
        lambda *a: _ssd_chunked(*a, cfg), [px, ps], (xs, px), (dt, pt),
        (A, pa), (Bh, px), (Ch, px))
    y = y + p["D"][None, None, :, None].to(y.dtype) * xs
    y = y.reshape(B, T, di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.rms_eps)
    out = y @ p["out_proj"]
    return out, (new_conv_state, final_state)


def ssm_decode_step(x: torch.Tensor, p, cfg: ModelConfig, *,
                    conv_state: torch.Tensor, ssm_state: torch.Tensor,
                    sh: Shardings = UNSHARDED):
    """One-token decode.  x: [B, 1, d]; conv_state [B, K-1, C] and
    ssm_state [B, H, P, S] as ``ssm_block`` returns them.  Under ``sh``
    the state update runs on each rank's local shards (independent per
    batch row and head), laid out as the state."""
    B = x.shape[0]
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    G, S = cfg.ssm_groups, cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    z, xs, Bm, Cm, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)                 # [B, 1, C]
    window = torch.cat([conv_state.to(conv_in.dtype), conv_in],
                       dim=1)                                  # [B, K, C]
    y = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(y.float()).to(x.dtype)[:, None]
    new_conv_state = window[:, 1:]
    xs = conv_out[..., :di].reshape(B, H, P)
    Bm = conv_out[..., di: di + G * S].reshape(B, G, S)
    Cm = conv_out[..., di + G * S:].reshape(B, G, S)
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=1).float()      # [B, H, S]
    Ch = torch.repeat_interleave(Cm, rep, dim=1).float()
    dt = softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None, :])                         # [B, H]
    xf = xs.float()

    def update(ssm_state, decay, Bh, dt, xf, Ch):
        new_state = (ssm_state * decay[:, :, None, None]
                     + torch.einsum("bhs,bh,bhp->bhps", Bh, dt, xf))
        return new_state, torch.einsum("bhs,bhps->bhp", Ch, new_state)

    # the state's batch and head shards, which every operand ([B, H, ...])
    # takes on its leading dims
    ps = sh.leading(ssm_state, 2)
    new_state, yt = sh.local(update, [ps, ps], *(
        (t, ps) for t in (ssm_state, decay, Bh, dt, xf, Ch)))
    yt = yt + p["D"][None, :, None] * xf                      # the D skip
    yt = yt.reshape(B, 1, di).to(x.dtype)
    yt = rms_norm(yt * F.silu(z.float()).to(yt.dtype), p["norm"],
                  cfg.rms_eps)
    out = yt @ p["out_proj"]
    return out, (new_conv_state, new_state)
