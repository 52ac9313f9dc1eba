"""Step factories for serving: prefill_step and serve_step (single-token
decode with cache), plus the forward cross-entropy.

Batch layout, as in the reference:

    prefill: {"tokens": [B, T] int64, "frontend": [B, P, d] (vlm/audio)}
    decode:  (cache, tokens [B, 1], pos int)

The model holds its weights, so the steps take no params argument.
"""
from __future__ import annotations

import torch

from .transformer import Model

__all__ = ["cross_entropy", "make_prefill_step", "make_serve_step",
           "pad_cache"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE, in fp32 (forward only)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(lse - ll)


def make_prefill_step(model: Model):
    """prefill(batch) -> (last_logits [B, V], cache)."""

    def prefill_step(batch):
        logits, cache, _ = model.forward(
            batch["tokens"], frontend_embeds=batch.get("frontend"),
            collect_cache=True)
        # a copy, so the [B, T, V] logits are freed on return
        return logits[:, -1].clone(), cache

    return prefill_step


def pad_cache(model: Model, cache, extra: int):
    """Grow full-attention KV caches by ``extra`` slots (prefill->generate).

    Prefill returns caches sized to the prompt; decoding appends at
    ``pos >= prompt_len``, which needs headroom.  Only non-windowed
    attention states grow (ring buffers and SSM/RG-LRU states are
    fixed-size by construction); cross-attention caches are static.  A
    layer's cache is ``[B, S, KV, D]``: the sequence axis is 1.
    """
    cfg = model.cfg

    def pad_attn(state):
        return tuple(torch.cat([t, t.new_zeros((t.shape[0], extra)
                                               + tuple(t.shape[2:]))], dim=1)
                     for t in state)

    def pad_state(kind, state):
        if cfg.is_encdec:
            inner, cross = state
            if kind in ("attn", "moe"):
                inner = pad_attn(inner)
            return (inner, cross)
        if kind in ("attn", "moe") and not (
                cfg.family == "hybrid" and cfg.window):
            return pad_attn(state)
        return state

    layers = [pad_state(kind, st)
              for kind, st in zip(model.kinds, cache["layers"])]
    return {"layers": layers, "memory": cache.get("memory")}


def make_serve_step(model: Model):
    """serve(cache, tokens [B, 1], pos) -> (logits [B, 1, V], cache)."""

    def serve_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)

    return serve_step
