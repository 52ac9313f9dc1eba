"""The port's ``models/`` against the reference's, on the CPU.

Each of the ten SMOKE architectures is initialized by the reference
(``Model.init``), its weights carried across by ``params_from_reference``,
and both packages run the same numpy tokens: forward logits, prefill's
last logits and one decode step after ``pad_cache`` agree at rtol/atol
2e-4 (the reference's own decode tolerance).  Then the pieces the smoke
shapes do not reach: the blockwise attention path, MoE dispatch with
dropped tokens, the chunked SSD scan with a ragged tail and a carried
state, the RG-LRU scan with ``h0``, and a bfloat16 tree (whose path
``test_torch_models_bf16.py`` holds against the reference).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get as ref_get
from repro.models import attention as RATT
from repro.models import moe as RMOE
from repro.models import rglru as RRG
from repro.models import ssm as RSSM
from repro.models.layers import Initializer as RInit
from repro.models.steps import cross_entropy as ref_cross_entropy
from repro.models.steps import make_prefill_step as ref_prefill
from repro.models.steps import make_serve_step as ref_serve
from repro.models.steps import pad_cache as ref_pad
from repro.models.transformer import make_model as ref_model
from repro_torch.configs import ARCHS, get
from repro_torch.models import (Model, cross_entropy, make_prefill_step,
                                make_serve_step, pad_cache,
                                params_from_reference)
from repro_torch.models import attention as ATT
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM

TOL = dict(rtol=2e-4, atol=2e-4)
B, T = 2, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def pair(cfg, seed=0):
    """The reference's model and weights, and the port's model on them."""
    ref = ref_model(cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    port = Model(cfg, device="cpu",
                 params=params_from_reference(_np(params), cfg,
                                              device="cpu"))
    return ref, params, port


def inputs(cfg, n_tokens, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_unpadded, (B, n_tokens)).astype(
        np.int32)
    fe = None
    if cfg.frontend != "none":
        fe = rng.standard_normal((B, cfg.frontend_tokens,
                                  cfg.d_model)).astype(np.float32)
    return tokens, fe


def test_registry_matches_the_reference():
    assert ARCHS == REF_ARCHS
    for arch in ARCHS:
        for smoke in (False, True):
            assert dataclasses.asdict(get(arch, smoke)) == \
                dataclasses.asdict(ref_get(arch, smoke))
            assert get(arch, smoke).param_count() == \
                ref_get(arch, smoke).param_count()
    full = get("llama3.2-1b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab) == (16, 2048, 32, 8, 8192, 128256)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_forward_prefill_decode(arch):
    cfg = get(arch, smoke=True)
    ref, params, port = pair(cfg)
    tokens, fe = inputs(cfg, T + 1)
    jfe = None if fe is None else jnp.asarray(fe)
    tfe = None if fe is None else _t(fe)

    r_logits, _, r_aux = jax.jit(ref.forward)(params, jnp.asarray(tokens),
                                              frontend_embeds=jfe)
    p_logits, _, p_aux = port.forward(_t(tokens).long(),
                                      frontend_embeds=tfe)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits),
                               **TOL)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(p_aux[key]), float(r_aux[key]),
                                   **TOL)

    batch = {"tokens": jnp.asarray(tokens[:, :T])}
    tbatch = {"tokens": _t(tokens[:, :T]).long()}
    if fe is not None:
        batch["frontend"], tbatch["frontend"] = jfe, tfe
    r_last, r_cache = jax.jit(ref_prefill(ref))(params, batch)
    p_last, p_cache = make_prefill_step(port)(tbatch)
    np.testing.assert_allclose(p_last.numpy(), np.asarray(r_last), **TOL)

    pos = T + (cfg.frontend_tokens
               if cfg.frontend != "none" and not cfg.is_encdec else 0)
    r_cache = ref_pad(ref, r_cache, extra=4)
    p_cache = pad_cache(port, p_cache, extra=4)
    r_dec, _ = jax.jit(ref_serve(ref))(params, r_cache,
                                       jnp.asarray(tokens[:, T:]),
                                       jnp.int32(pos))
    p_dec, _ = make_serve_step(port)(p_cache, _t(tokens[:, T:]).long(),
                                     pos)
    np.testing.assert_allclose(p_dec.numpy(), np.asarray(r_dec), **TOL)


def _attn_pair(cfg, seed=0):
    p = RATT.attention_params(RInit(jax.random.PRNGKey(seed)), cfg,
                              jnp.float32)
    return p, {k: _t(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_reference(causal, window):
    """dense_threshold=0 forces the online-softmax path; ragged chunks
    (T = 19 over chunks of 4 and 8) and skipped chunks included."""
    cfg = get("llama3.2-1b", smoke=True)
    rp, tp = _attn_pair(cfg)
    x = np.random.default_rng(1).standard_normal(
        (B, 19, cfg.d_model)).astype(np.float32)
    pos = np.arange(19)
    kw = dict(causal=causal, window=window, dense_threshold=0, q_chunk=4,
              kv_chunk=8)
    r_out, (rk, rv) = RATT.attention(jnp.asarray(x), rp, cfg,
                                     positions=jnp.asarray(pos), **kw)
    p_out, (pk, pv) = ATT.attention(_t(x), tp, cfg, positions=_t(pos), **kw)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out), **TOL)
    np.testing.assert_allclose(pk.numpy(), np.asarray(rk), **TOL)
    # and the port's two paths agree with each other
    dense, _ = ATT.attention(_t(x), tp, cfg, positions=_t(pos),
                             causal=causal, window=window)
    np.testing.assert_allclose(p_out.numpy(), dense.numpy(), **TOL)


@pytest.mark.parametrize("pos", [3, 8, 21])
def test_windowed_decode_attention_ring(pos):
    """A window layer's ring: slot ``pos % S``, mask by ring age, also
    past the window."""
    cfg = get("recurrentgemma-2b", smoke=True)
    rp, tp = _attn_pair(cfg, seed=2)
    rng = np.random.default_rng(pos)
    S = cfg.window
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, S, cfg.n_kv_heads,
                              cfg.head_dim_)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    r_out, rk, rv = RATT.decode_attention(
        jnp.asarray(x), rp, cfg, cache_k=jnp.asarray(ck),
        cache_v=jnp.asarray(cv), pos=jnp.int32(pos), window=S)
    tck = _t(ck)
    p_out, pk, pv = ATT.decode_attention(_t(x), tp, cfg, cache_k=tck,
                                         cache_v=_t(cv), pos=pos, window=S)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out), **TOL)
    np.testing.assert_allclose(pk.numpy(), np.asarray(rk), **TOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), **TOL)
    # the new K went into slot pos % S of the given cache, in place
    assert pk is tck
    others = np.arange(S) != pos % S
    assert np.array_equal(tck.numpy()[:, others], ck[:, others])


def _dropped(top_e: np.ndarray, C: int) -> np.ndarray:
    """Which (token, choice) pairs overflow their expert, from the
    reference's choices: rank within the expert in flat order >= C."""
    Bq, Tq, k = top_e.shape
    flat = top_e.reshape(Bq, Tq * k)
    out = np.zeros_like(flat, bool)
    for b in range(Bq):
        seen = {}
        for j, e in enumerate(flat[b]):
            out[b, j] = seen.get(e, 0) >= C
            seen[e] = seen.get(e, 0) + 1
    return out


def test_moe_block_drops_the_same_tokens():
    cfg = get("granite-moe-1b-a400m", smoke=True)
    rp = RMOE.moe_params(RInit(jax.random.PRNGKey(3)), cfg, jnp.float32)
    # a sharper router and a shared direction in every token, so that the
    # choices pile onto a few experts and overflow their capacity
    rp["router"] = rp["router"] * 20.0
    tp = {k: _t(np.asarray(v)) for k, v in rp.items()}
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((B, 24, cfg.d_model))
         + 1.5 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    r_y, r_aux = jax.jit(lambda x_, p_: RMOE.moe_block(x_, p_, cfg))(
        jnp.asarray(x), rp)
    p_y, p_aux = MOE.moe_block(_t(x), tp, cfg)
    np.testing.assert_allclose(p_y.numpy(), np.asarray(r_y), **TOL)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(p_aux[key]), float(r_aux[key]),
                                   **TOL)
    # the choices and the drops behind those outputs are the reference's
    logits = jnp.einsum("btd,de->bte", jnp.asarray(x), rp["router"])
    _, r_e = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)
    _, p_e = MOE._top_k(torch.softmax(_t(x) @ tp["router"], -1), cfg.top_k)
    assert np.array_equal(p_e.numpy(), np.asarray(r_e))
    C = MOE._capacity(24, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    assert C == RMOE._capacity(24, cfg.top_k, cfg.n_experts,
                               cfg.capacity_factor)
    assert _dropped(np.asarray(r_e), C).sum() > 0    # tokens are dropped


def test_moe_top_k_breaks_ties_to_the_lowest_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3, 0.0]])
    vals, idx = MOE._top_k(probs, 3)
    r_vals, r_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(r_idx).tolist() == [[1, 2, 3]]


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_ragged_tail(with_state):
    cfg = dataclasses.replace(get("mamba2-2.7b", smoke=True), ssm_chunk=8)
    rng = np.random.default_rng(5)
    Tq, H, P = 21, cfg.ssm_heads, cfg.ssm_head_dim
    G, S = cfg.ssm_groups, cfg.ssm_state
    x = rng.standard_normal((B, Tq, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, Tq, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, Tq, G, S)).astype(np.float32)
    Cm = rng.standard_normal((B, Tq, G, S)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, P, S)).astype(np.float32)
          if with_state else None)
    r_y, r_s = RSSM._ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), cfg,
        init_state=None if s0 is None else jnp.asarray(s0))
    p_y, p_s = SSM._ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), cfg,
                                init_state=None if s0 is None else _t(s0))
    np.testing.assert_allclose(p_y.numpy(), np.asarray(r_y), **TOL)
    np.testing.assert_allclose(p_s.numpy(), np.asarray(r_s), **TOL)


def test_rglru_scan_with_carried_state():
    cfg = get("recurrentgemma-2b", smoke=True)
    rp = RRG.rglru_params(RInit(jax.random.PRNGKey(6)), cfg, jnp.float32)
    tp = {k: _t(np.asarray(v)) for k, v in rp.items()}
    rng = np.random.default_rng(7)
    xr = rng.standard_normal((B, 13, cfg.rnn_width_)).astype(np.float32)
    h0 = rng.standard_normal((B, cfg.rnn_width_)).astype(np.float32)
    for init in (None, h0):
        r_h, r_last = jax.jit(RRG._rglru_scan)(
            jnp.asarray(xr), rp, None if init is None else jnp.asarray(init))
        p_h, p_last = RG._rglru_scan(_t(xr), tp,
                                     None if init is None else _t(init))
        np.testing.assert_allclose(p_h.numpy(), np.asarray(r_h), **TOL)
        np.testing.assert_allclose(p_last.numpy(), np.asarray(r_last),
                                   **TOL)


def test_params_from_reference_bfloat16_tree():
    """A bfloat16 tree (dtype name ``"bfloat16"``) arrives bit for bit as
    ``torch.bfloat16`` through its uint16 bits, and the model runs on it."""
    cfg = dataclasses.replace(get("recurrentgemma-2b", smoke=True),
                              n_layers=7, param_dtype="bfloat16")
    ref = ref_model(cfg)
    tree = _np(ref.init(jax.random.PRNGKey(8)))
    assert tree["embed"].dtype.name == "bfloat16"
    sd = params_from_reference(tree, cfg, device="cpu")
    assert sd["embed"].dtype == torch.bfloat16
    assert np.array_equal(sd["embed"].view(torch.int16).numpy(),
                          tree["embed"].view(np.int16))
    # a stacked leaf: pattern position 1 ("rec"), row 1 is layer 4
    for want, got in ((tree["blocks"]["1"]["rec"]["w_in_x"][1],
                       sd["layers.4.rec.w_in_x"]),
                      (tree["rem"][0]["rec"]["w_out"],
                       sd["layers.6.rec.w_out"])):
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16))
    assert sd["layers.4.rec.w_a"].dtype == torch.float32   # fp32 leaves
    port = Model(cfg, device="cpu", params=sd)
    tokens, _ = inputs(cfg, T)
    logits, _, _ = port.forward(_t(tokens).long())
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(9)
    logits = (3 * rng.standard_normal((B, T, 128))).astype(np.float32)
    labels = rng.integers(0, 128, (B, T)).astype(np.int32)
    want = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = cross_entropy(_t(logits), _t(labels).long())
    np.testing.assert_allclose(float(got), float(want), **TOL)
