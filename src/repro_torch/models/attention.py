"""Attention: GQA/MQA/MHA, causal / sliding-window / cross, KV-cache decode.

Two execution paths, as in the reference:
  * dense — materializes [B, H, Tq, Tk] scores; used for short sequences and
    single-token decode (where Tq == 1).
  * blockwise — online softmax over KV chunks, one query chunk at a time;
    chunks outside the causal band or the window are skipped.  It keeps
    peak memory at O(q_chunk x kv_chunk) per (B, H) and is the path taken
    when ``max(T, S) > cfg.attn_dense_threshold``.

Plain PyTorch: the reference has no attention kernel either.  All softmax
math is fp32 whatever the activation dtype; the probabilities are cast to
the activation dtype before P.V.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..launch.sharding import UNSHARDED, Shardings
from .config import ModelConfig
from .layers import Initializer, dense_init, rope

__all__ = ["attention_params", "attention", "decode_attention"]

_NEG_INF = -2.0 ** 30


def attention_params(init: Optional[Initializer], cfg: ModelConfig, dtype,
                     device) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    H, KV = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(init, (d, H * hd), dtype, device),
        "wk": dense_init(init, (d, KV * hd), dtype, device),
        "wv": dense_init(init, (d, KV * hd), dtype, device),
        "wo": dense_init(init, (H * hd, d), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
    return p


def _project_qkv(x, p, cfg: ModelConfig, positions, xk=None):
    """Project to q, k, v heads (k/v from ``xk`` for cross-attention)."""
    B, T, _ = x.shape
    hd = cfg.head_dim_
    src = x if xk is None else xk
    S = src.shape[1]
    q = x @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if positions is not None and xk is None:      # no RoPE on cross-attn
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, H, D] by repeating KV groups."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _dense_attention(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    """q: [B,T,H,D]; k,v: [B,S,H,D] -> [B,T,H,D].  fp32 softmax."""
    D = q.shape[-1]
    scores = torch.einsum("bthd,bshd->bhts", q, k).float()
    scores = scores * (D ** -0.5)
    T, S = scores.shape[-2], scores.shape[-1]
    tpos = torch.arange(T, device=q.device)[:, None]
    spos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= spos <= tpos
    if window:
        mask &= spos > tpos - window
    scores = torch.where(mask[None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _blockwise_attention(q, k, v, *, causal: bool, window: int,
                         q_chunk: int, kv_chunk: int) -> torch.Tensor:
    """Online-softmax blockwise attention (flash-style, plain PyTorch).

    Loops over query chunks; per query chunk, over KV chunks with a
    running (max, denom, acc) triple.  A KV chunk beyond the causal
    frontier or outside the window is skipped, as the reference's
    ``lax.cond`` skips it.
    """
    B, T, H, D = q.shape
    S = k.shape[1]
    nq = -(-T // q_chunk)
    nk = -(-S // kv_chunk)
    Tp, Sp = nq * q_chunk, nk * kv_chunk
    dev = q.device

    def pad(t, n):
        if n == t.shape[1]:
            return t
        z = t.new_zeros((B, n - t.shape[1]) + tuple(t.shape[2:]))
        return torch.cat([t, z], dim=1)

    qp = pad(q, Tp).reshape(B, nq, q_chunk, H, D)
    kp = pad(k, Sp).reshape(B, nk, kv_chunk, H, D)
    vp = pad(v, Sp).reshape(B, nk, kv_chunk, H, D)
    scale = D ** -0.5
    outs = []
    for qi in range(nq):
        qb = qp[:, qi]                                     # [B, qc, H, D]
        q_lo = qi * q_chunk
        m = torch.full((B, H, q_chunk), _NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_chunk, D), dtype=torch.float32,
                          device=dev)
        tpos = q_lo + torch.arange(q_chunk, device=dev)[:, None]
        for ki in range(nk):
            k_lo = ki * kv_chunk
            # the chunk participates iff it meets the causal/window band
            if causal and not k_lo <= q_lo + q_chunk - 1:
                continue
            if window and not (k_lo + kv_chunk) > (q_lo - window + 1):
                continue
            kb, vb = kp[:, ki], vp[:, ki]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb).float() * scale
            spos = k_lo + torch.arange(kv_chunk, device=dev)[None, :]
            mask = spos < S
            if causal:
                mask = mask & (spos <= tpos)
            if window:
                mask = mask & (spos > tpos - window)
            s = torch.where(mask[None, None], s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(qb.dtype), vb).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))                       # [B, H, qc, D]
    out = torch.stack(outs, dim=2).reshape(B, H, Tp, D)
    return out.transpose(1, 2)[:, :T]                      # [B, T, H, D]


def attention(x: torch.Tensor, p, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor], causal: bool = True,
              window: int = 0, memory: Optional[torch.Tensor] = None,
              sh: Shardings = UNSHARDED, dense_threshold: int = -1,
              q_chunk: int = 1024,
              kv_chunk: int = 1024
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full attention over a sequence (prefill).

    Returns (output [B, T, d], (k, v) for cache population).
    ``memory``: encoder output for cross-attention (no causal mask, no
    RoPE).
    """
    if memory is not None:
        causal = False
    q, k, v = _project_qkv(x, p, cfg, positions, xk=memory)
    q = sh.act(q, "batch", "seq_unsharded", "heads", None)
    k = sh.act(k, "batch", "seq_unsharded", "kv_heads", None)
    v = sh.act(v, "batch", "seq_unsharded", "kv_heads", None)
    kr = _repeat_kv(k, cfg.n_heads)
    vr = _repeat_kv(v, cfg.n_heads)
    T, S = q.shape[1], kr.shape[1]
    if dense_threshold < 0:
        dense_threshold = cfg.attn_dense_threshold

    def core(q, kr, vr):
        if max(T, S) <= dense_threshold:
            return _dense_attention(q, kr, vr, causal=causal, window=window)
        return _blockwise_attention(q, kr, vr, causal=causal, window=window,
                                    q_chunk=q_chunk, kv_chunk=kv_chunk)

    # each (batch, head) attends on its own: the core runs on the local
    # shards, laid out as q (the sequence whole)
    pl = sh.placements(q.shape, "batch", "seq_unsharded", "heads", None)
    o = sh.local(core, pl, (q, pl), (kr, pl), (vr, pl))
    B = x.shape[0]
    out = o.reshape(B, T, cfg.n_heads * cfg.head_dim_) @ p["wo"]
    return out, (k, v)


def decode_attention(x: torch.Tensor, p, cfg: ModelConfig, *,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: int, window: int = 0,
                     memory: Optional[torch.Tensor] = None,
                     sh: Shardings = UNSHARDED
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode step.

    x: [B, 1, d]; cache_k/v: [B, S, KV, D]; pos: the current absolute
    position (an int).  Returns (out [B, 1, d], cache_k, cache_v): the new
    position's K/V are written into their slot of the given caches in
    place.  A sliding-window layer's cache is a ring of ``window`` slots
    written at ``pos % S``, which is what keeps hybrid decode state
    bounded.  Grouped-query heads read their KV head of the cache without
    a repeated copy: query head ``h = kv * G + g`` reads KV head ``kv``.
    Under ``sh`` the slot write and the attention run on each rank's
    local shards, laid out as the cache.
    """
    B = x.shape[0]
    pos = int(pos)
    S = cache_k.shape[1]
    if memory is not None:
        # cross-attention reads the (static, pre-projected) encoder memory
        # from the cache; no RoPE on cross-attention queries
        q, _, _ = _project_qkv(x, p, cfg, None, xk=x)
        k1 = v1 = None
    else:
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
        q, k1, v1 = _project_qkv(x, p, cfg, positions)
    slot = min(max(pos % S if window else pos, 0), S - 1)
    G = cfg.n_heads // cfg.n_kv_heads

    def core(q, cache_k, cache_v, *new):
        if new:
            cache_k[:, slot] = new[0][:, 0].to(cache_k.dtype)
            cache_v[:, slot] = new[1][:, 0].to(cache_v.dtype)
        b, KV, D = q.shape[0], cache_k.shape[2], q.shape[-1]
        qg = q.reshape(b, 1, KV, G, D)
        scores = torch.einsum("btkgd,bskd->bkgts", qg,
                              cache_k.to(q.dtype)).float()
        scores = scores.reshape(b, KV * G, 1, S) * (D ** -0.5)
        spos = torch.arange(S, device=q.device)[None, None, None, :]
        if memory is not None:
            mask = None
        elif window:
            # ring buffer: valid slots are those already written (< pos+1)
            # and within the window; slot ages are ring arithmetic (floor
            # modulo)
            age = torch.remainder(pos - spos, S)
            mask = age < min(pos + 1, window)
        else:
            mask = spos <= pos
        if mask is not None:
            scores = torch.where(mask, scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        o = torch.einsum("bkgts,bskd->btkgd",
                         probs.reshape(b, KV, G, 1, S), cache_v.to(q.dtype))
        return o.reshape(b, 1, KV * G, D)

    new = () if k1 is None else (k1, v1)
    # laid out as the cache; under a mesh the caches are written in place
    # through their local shards, which autograd forbids on a view of a
    # DTensor: the sharded decode step is a serving step and takes no
    # gradient
    pl = sh.leading(cache_k, cache_k.ndim)
    with torch.set_grad_enabled(torch.is_grad_enabled() and sh.mesh is None):
        o = sh.local(core, pl, (q, pl), (cache_k, pl), (cache_v, pl),
                     *((t, pl) for t in new))
    out = o.reshape(B, 1, cfg.n_heads * cfg.head_dim_) @ p["wo"]
    return out, cache_k, cache_v
