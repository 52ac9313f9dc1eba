"""The port's bfloat16 model path against the reference's, on the CPU.

The published configs keep their parameters in bfloat16, and so does the
model the card serves.  Here the reference initializes a SMOKE config in
bfloat16, ``params_from_reference`` carries the tree across through its
uint16 bits, and both packages run the same numpy tokens.  The reference
runs op by op (``jax.disable_jit``), so each of its operations rounds to
bfloat16 as the port's do; under a jit XLA may keep excess precision
between fused operations, which moves logits by a few bfloat16 ulps.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.steps import make_prefill_step as ref_prefill
from repro.models.steps import make_serve_step as ref_serve
from repro.models.steps import pad_cache as ref_pad
from repro.models.transformer import make_model as ref_model
from repro_torch.configs import get
from repro_torch.models import (Model, make_prefill_step, make_serve_step,
                                pad_cache, params_from_reference)

B, T = 2, 12


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen1.5-110b"])
def test_bfloat16_forward_prefill_decode(arch):
    """Forward logits, prefill's last logits and one decode step after
    ``pad_cache`` agree with the reference within one bfloat16 ulp of the
    largest logit, and pick the same argmax wherever the two top logits
    are further apart than two.  llama3.2-1b is the path the card serves;
    qwen adds the qkv bias."""
    cfg = dataclasses.replace(get(arch, smoke=True),
                              param_dtype="bfloat16")
    ref = ref_model(cfg)
    params = ref.init(jax.random.PRNGKey(8))
    port = Model(cfg, device="cpu",
                 params=params_from_reference(
                     jax.tree.map(np.asarray, params), cfg, device="cpu"))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_unpadded, (B, T + 1)).astype(np.int32)
    with jax.disable_jit():
        r_logits, _, _ = ref.forward(params, jnp.asarray(tokens))
        r_last, r_cache = ref_prefill(ref)(
            params, {"tokens": jnp.asarray(tokens[:, :T])})
        r_dec, _ = ref_serve(ref)(params, ref_pad(ref, r_cache, extra=4),
                                  jnp.asarray(tokens[:, T:]), jnp.int32(T))
    p_logits, _, _ = port.forward(_t(tokens).long())
    p_last, p_cache = make_prefill_step(port)(
        {"tokens": _t(tokens[:, :T]).long()})
    p_dec, _ = make_serve_step(port)(pad_cache(port, p_cache, extra=4),
                                     _t(tokens[:, T:]).long(), T)
    for got, want in ((p_logits, r_logits), (p_last, r_last),
                      (p_dec, r_dec)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * ulp
        assert clear.any()
        assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
