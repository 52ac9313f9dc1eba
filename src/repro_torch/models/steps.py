"""Step factories: train_step (CE + AdamW + microbatching + remat),
prefill_step, and serve_step (single-token decode with cache).

Batch layout, as in the reference:

    train:   {"tokens": [B, T] int64, "labels": [B, T] int64,
              "frontend": [B, P, d] f32 (vlm/audio only)}
    prefill: {"tokens": [B, T], "frontend": ...}
    decode:  (cache, tokens [B, 1], pos int)

The model holds its weights, so the serving steps take no params
argument.  A train state is ``{"params": {name: tensor}, "opt": {"m",
"v", "step"}}``: ``init_train_state`` takes the model's own parameters,
and a step binds the state's tensors into the model first, so a restored
state (new tensors, maybe on another device) trains the same model.  A
step updates the state's tensors in place and returns the same dict.

With ``microbatches=k`` the batch is cut into k parts of ``B // k`` rows
and the gradients are accumulated in ``accum_dtype`` (a Python loop, the
reference's ``lax.scan``): the activation working set shrinks k-fold
while the optimizer sees the full-batch gradient.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..launch.sharding import UNSHARDED, Shardings
from ..train.optimizer import AdamWConfig, adamw_init, adamw_update
from .transformer import Model

__all__ = ["cross_entropy", "make_train_step", "make_prefill_step",
           "make_serve_step", "init_train_state", "loss_and_grads",
           "pad_cache"]

_AUX_LB_WEIGHT = 0.01
_AUX_Z_WEIGHT = 1e-3


class _Promote(torch.autograd.Function):
    """Cast to fp32; the backward returns the cotangent in the primal's
    dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.to(torch.float32) if x.dtype != torch.float32 \
            else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def _promote_f32(x: torch.Tensor) -> torch.Tensor:
    """Cast to fp32 whose *backward* returns the original dtype: the fp32
    loss cotangent does not run down the residual stream in fp32.  The
    forward math is unchanged; only the cotangent is cast."""
    return _Promote.apply(x)


class _VocabParallelCE(torch.autograd.Function):
    """Each token's CE over logits whose vocab dim is sharded over one
    mesh dim (Megatron's vocab-parallel loss): the max, the sum of
    exponentials and the label's logit are all-reduced over that dim's
    group, so no rank holds the whole vocab.  fp32 math; the backward is
    local (softmax minus the one-hot, times the cotangent) and returns the
    logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels, axis):
        from torch.distributed import _functional_collectives as funcol
        mesh, i = axis
        x = logits.float()
        V = x.shape[-1]
        m = funcol.all_reduce(x.amax(-1), "max", axis)
        p = torch.exp(x - m[..., None])
        s = funcol.all_reduce(p.sum(-1), "sum", axis)
        local = labels - mesh.get_local_rank(i) * V
        mine = (local >= 0) & (local < V)
        idx = torch.where(mine, local, 0)[..., None]
        ll = torch.where(mine, torch.gather(x, -1, idx)[..., 0], 0.0)
        ll = funcol.all_reduce(ll, "sum", axis)
        p.div_(s[..., None])                           # the softmax
        ctx.save_for_backward(p, idx, mine)
        ctx.dtype = logits.dtype
        return torch.log(s) + m - ll

    @staticmethod
    def backward(ctx, g):
        p, idx, mine = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, idx, torch.where(mine, -g, 0.0)[..., None])
        return grad.to(ctx.dtype), None, None


def _token_ce(logits: torch.Tensor, labels: torch.Tensor,
              axis=None) -> torch.Tensor:
    """Each token's CE in fp32 math, original-dtype backward; over
    vocab shards when ``axis`` names the mesh dim that shards them."""
    if axis is not None:
        return _VocabParallelCE.apply(logits, labels, axis)
    logits = _promote_f32(logits)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return lse - ll


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in fp32 math, original-dtype backward."""
    return torch.mean(_token_ce(logits, labels))


def _loss_fn(model: Model, batch, remat: bool, sh: Shardings):
    logits, _, aux = model.forward(
        batch["tokens"], frontend_embeds=batch.get("frontend"), remat=remat,
        sh=sh)
    labels = batch["labels"]
    T = labels.shape[1]
    logits = logits[:, -T:]          # vlm/audio: loss on text positions only
    # each rank's rows over its vocab shard, laid out as the unembedding
    # leaves the logits (DTensor's label gather along a vocab-sharded dim
    # fails, and its backward zero-fills the logits' global shape)
    lpl = sh.placements(logits.shape, "batch", "seq_unsharded", "vocab")
    pl = sh.placements(labels.shape, "batch", "seq_unsharded")
    axis = sh.axis_of(lpl, 2)
    loss = torch.mean(sh.local(lambda lg, lb: _token_ce(lg, lb, axis), pl,
                               (logits, lpl), (labels, pl)))
    total = loss + _AUX_LB_WEIGHT * aux["load_balance"] \
        + _AUX_Z_WEIGHT * aux["router_z"]
    return total, {"ce": loss, **aux}


def _bind(model: Model, params: Dict[str, torch.Tensor]) -> None:
    """Make ``params`` the model's parameters, trainable.  A tensor that is
    not yet one of the model's (a restored state's) is wrapped in a
    parameter sharing its storage, and the state keeps that parameter."""
    for name, t in params.items():
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        if mod._parameters.get(attr) is t:
            continue
        if attr not in mod._parameters:
            raise KeyError(f"{name} is not a parameter of {model.cfg.name}")
        p = t if isinstance(t, nn.Parameter) else nn.Parameter(t)
        p.requires_grad_(True)
        mod._parameters[attr] = p
        params[name] = p


def init_train_state(model: Model,
                     opt_cfg: Optional[AdamWConfig] = None) -> dict:
    """The model's parameters, made trainable, and zero AdamW moments in
    ``opt_cfg.moment_dtype``.  Serving models keep ``requires_grad``
    off; this is where training turns it on."""
    opt_cfg = opt_cfg or AdamWConfig()
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return {"params": params,
            "opt": adamw_init(params, opt_cfg.moment_dtype)}


def _backward(loss: torch.Tensor, leaves, sink) -> None:
    """Backpropagate ``loss`` to ``leaves``, handing ``sink(i, g)`` leaf
    i's gradient as soon as it is complete (the leaf's ``.grad`` is left
    empty); a leaf the loss does not reach gets no call.  Under a mesh a
    weight's gradient comes out of its last use a partial sum at its
    gathered size (DTensor does not lay a gradient out as its leaf): the
    sink reduces it to the leaf's shard there, so no more than a layer's
    gathered gradients are alive at once, as the reference's partitioned
    backward holds them."""
    handles = []
    for i, p in enumerate(leaves):
        p.grad = None

        def hook(p, i=i):
            g, p.grad = p.grad, None
            sink(i, g)

        handles.append(p.register_post_accumulate_grad_hook(hook))
    try:
        torch.autograd.backward(loss, inputs=leaves)
    finally:
        for h in handles:
            h.remove()


def loss_and_grads(model: Model, params: Dict[str, torch.Tensor], batch, *,
                   microbatches: int = 1, remat: bool = True,
                   accum_dtype=torch.float32,
                   sh: Optional[Shardings] = None):
    """(loss, parts, grads) of the training loss at ``params``: the
    gradient half of a train step.  ``grads`` is ``{name: tensor}`` in the
    parameters' dtype, or in ``accum_dtype`` when ``microbatches > 1``
    (the parts summed, then divided once); under a mesh each laid out as
    its parameter, a partial sum reduced in fp32 with one microbatch (the
    dtype the optimizer reads it in) and in ``accum_dtype`` with several
    (the sum's)."""
    _bind(model, params)
    sh = UNSHARDED if sh is None else sh
    names = list(params)
    leaves = [params[n] for n in names]
    if microbatches == 1:
        loss, parts = _loss_fn(model, batch, remat, sh)
        grads = [None] * len(leaves)

        def keep(i, g):
            grads[i] = sh.like(g, leaves[i], torch.float32)

        _backward(loss, leaves, keep)
        # zeros for a leaf the loss does not reach (a frontend adapter with
        # no frontend in the batch), as the reference's value_and_grad
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
            dict(zip(names, grads))
    # zeros_like: a DTensor parameter's sum takes its placements
    g_sum = [torch.zeros_like(p, dtype=accum_dtype) for p in leaves]
    l_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    parts_all = []

    def add(i, g):
        g_sum[i].add_(sh.like(g, leaves[i], accum_dtype).to(accum_dtype))

    for i in range(microbatches):
        # rows [i * rows, (i + 1) * rows): the reference's reshape to
        # [microbatches, rows, ...] and its row i (a slice, which DTensor also
        # takes of a batch sharded over several mesh axes)
        rows = next(iter(batch.values())).shape[0] // microbatches
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        loss, parts = _loss_fn(model, mb, remat, sh)
        _backward(loss, leaves, add)
        l_sum = l_sum + loss.detach()
        parts_all.append({k: v.detach() for k, v in parts.items()})
    grads = {n: a / microbatches for n, a in zip(names, g_sum)}
    parts = {k: torch.stack([p[k] for p in parts_all]).mean()
             for k in parts_all[0]}
    return l_sum / microbatches, parts, grads


def make_train_step(model: Model, *, sh: Optional[Shardings] = None,
                    opt_cfg: Optional[AdamWConfig] = None,
                    microbatches: int = 1, remat: bool = True,
                    accum_dtype=torch.float32):
    """Build ``train_step(state, batch) -> (state, metrics)``; the metrics
    are the reference's: ``loss``, ``ce``, ``load_balance``,
    ``router_z``, ``grad_norm`` and ``lr`` (0-d tensors on the device).
    Under ``sh`` the state is ``launch.sharding.shard_state``'s DTensors
    and the batch DTensors placed by ``batch_placements``."""
    opt_cfg = opt_cfg or AdamWConfig()
    sh = UNSHARDED if sh is None else sh

    def train_step(state, batch):
        params = state["params"]
        with sh.scope():
            loss, parts, grads = loss_and_grads(
                model, params, batch, microbatches=microbatches,
                remat=remat, accum_dtype=accum_dtype, sh=sh)
            new_params, new_opt, om = adamw_update(params, grads,
                                                   state["opt"], opt_cfg)
        metrics = {"loss": loss, **parts, **om}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_prefill_step(model: Model, *, sh: Optional[Shardings] = None):
    """prefill(batch) -> (last_logits [B, V], cache)."""
    sh = UNSHARDED if sh is None else sh

    def prefill_step(batch):
        with sh.scope():
            logits, cache, _ = model.forward(
                batch["tokens"], frontend_embeds=batch.get("frontend"),
                sh=sh, collect_cache=True)
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


def make_serve_step(model: Model, *, sh: Optional[Shardings] = None):
    """serve(cache, tokens [B, 1], pos) -> (logits [B, 1, V], cache)."""
    sh = UNSHARDED if sh is None else sh

    def serve_step(cache, tokens, pos):
        with sh.scope():
            return model.decode_step(cache, tokens, pos, sh=sh)

    return serve_step
