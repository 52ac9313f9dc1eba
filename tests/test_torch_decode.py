"""The port's decode path against its own forward pass, on the CPU.

Prefill + single-token decode must give the logits of a full forward over
the extended sequence: KV caches (dense, GQA repeat, ring-buffer windows),
SSM conv/state carries, RG-LRU recurrent state and enc-dec cross-attention
caches, on weights the port draws itself (seeded), at the reference's
tolerance (rtol/atol 2e-4).
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs import get
from repro_torch.models import (Model, make_prefill_step, make_serve_step,
                                pad_cache)

B, T = 2, 24
TOL = dict(rtol=2e-4, atol=2e-4)

ARCHS = ["llama3.2-1b", "granite-moe-1b-a400m", "mamba2-2.7b",
         "recurrentgemma-2b", "seamless-m4t-medium", "qwen1.5-110b"]


def _setup(arch, n_tokens, seed):
    cfg = get(arch, smoke=True)
    if cfg.family == "moe":
        # capacity drops differ between a T-token forward and a 1-token
        # decode; with room for every token the mechanism must agree
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    model = Model(cfg, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_unpadded, (B, n_tokens),
                           generator=gen)
    fe = None
    if cfg.frontend != "none":
        fe = torch.randn((B, cfg.frontend_tokens, cfg.d_model),
                         generator=gen)
    return cfg, model, tokens, fe


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    cfg, model, tokens, fe = _setup(arch, T + 1, seed=0)
    full, _, _ = model.forward(tokens, frontend_embeds=fe)
    batch = {"tokens": tokens[:, :T]}
    if fe is not None:
        batch["frontend"] = fe
    _, cache = make_prefill_step(model)(batch)
    cache = pad_cache(model, cache, extra=8)
    pos = T + (cfg.frontend_tokens
               if cfg.frontend != "none" and not cfg.is_encdec else 0)
    dec, _ = make_serve_step(model)(cache, tokens[:, T:T + 1], pos)
    torch.testing.assert_close(dec[:, 0], full[:, -1], **TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b"])
def test_multi_step_decode_matches_forward(arch):
    """Three decode steps in a row track the full forward; recurrentgemma
    (window 8) is past its window, so the ring wraps."""
    steps = 3
    cfg, model, tokens, _ = _setup(arch, T + steps, seed=1)
    if cfg.window:
        assert T > cfg.window
    _, cache = make_prefill_step(model)({"tokens": tokens[:, :T]})
    cache = pad_cache(model, cache, extra=steps + 1)
    serve = make_serve_step(model)
    for s in range(steps):
        dec, cache = serve(cache, tokens[:, T + s:T + s + 1], T + s)
        full, _, _ = model.forward(tokens[:, :T + s + 1])
        torch.testing.assert_close(dec[:, 0], full[:, -1], **TOL)


def test_decode_leaves_the_cache_it_was_given():
    """A decode step writes the new position's K/V into the slot ``pos``
    of every attention layer's cache, in place, and leaves every other
    entry of the cache it was given as it was."""
    cfg, model, tokens, _ = _setup("llama3.2-1b", T + 1, seed=2)
    _, cache = make_prefill_step(model)({"tokens": tokens[:, :T]})
    cache = pad_cache(model, cache, extra=2)
    before = [[t.clone() for t in st] for st in cache["layers"]]
    _, new = make_serve_step(model)(cache, tokens[:, T:], T)
    for old, given, out in zip(before, cache["layers"], new["layers"]):
        for a, b, c in zip(old, given, out):
            assert c is b
            assert torch.equal(a[:, :T], b[:, :T])
            assert torch.equal(a[:, T + 1:], b[:, T + 1:])
            assert not torch.equal(a[:, T], b[:, T])
