"""Port parity: summarization and z-order keys, PyTorch vs the JAX reference.

Both packages get the same numpy inputs.  Tolerances: breakpoints, codes,
keys, sort permutations and insertion points exact; PAA and the plain
bounds/distances at rtol 1e-6 (float32 reductions may be ordered
differently).  A code may differ only for a row whose reference PAA lies
within 4 ulp of a breakpoint, where one ulp of PAA flips the region.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import keys as RK
from repro.core import summarization as RS
from repro_torch.core import keys as K
from repro_torch.core import summarization as S

CFGS = [(64, 8, 4), (256, 16, 8), (64, 8, 1), (128, 16, 3)]


def _walks(n, L, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((n, L)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


def _near_breakpoint(paa: np.ndarray, bits: int, ulps: int = 4) -> np.ndarray:
    """[N] rows with a PAA value within ``ulps`` ulp of a breakpoint."""
    bps = RS._breakpoints_np(bits)
    gap = np.abs(paa[..., None] - bps)
    tol = ulps * np.spacing(np.abs(bps).astype(np.float32))
    return (gap <= tol).any(axis=(-1, -2))


@pytest.mark.parametrize("bits", range(1, 9))
def test_breakpoints_bit_equal(bits):
    ref = np.asarray(RS.breakpoints(bits))
    got = S.breakpoints(bits).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    lo, hi = S.region_bounds(bits)
    rlo, rhi = RS.region_bounds(bits)
    assert np.array_equal(lo.numpy(), np.asarray(rlo))
    assert np.array_equal(hi.numpy(), np.asarray(rhi))


@pytest.mark.parametrize("L,w,b", CFGS)
def test_summarize_and_keys_match_reference(L, w, b):
    x = _walks(700, L, seed=L + b)
    rcfg = RS.SummaryConfig(L, w, b)
    cfg = S.SummaryConfig(L, w, b)
    r_paa, r_codes = (np.array(a) for a in RS.summarize(jnp.asarray(x),
                                                          rcfg))
    paa, codes = S.summarize(torch.from_numpy(x), cfg)
    np.testing.assert_allclose(paa.numpy(), r_paa, rtol=1e-6, atol=0)
    ok = ~_near_breakpoint(r_paa, b)
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(codes.numpy()[ok], r_codes[ok])
    r_keys = np.asarray(RS.invsax_keys(jnp.asarray(r_codes), rcfg))
    keys = S.invsax_keys(torch.from_numpy(r_codes), cfg)
    assert keys.dtype == torch.int64
    np.testing.assert_array_equal(keys.numpy(), r_keys.astype(np.int64))


def test_znormalize_matches_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((50, 64)) * 3 + 1).astype(np.float32)
    ref = np.asarray(RS.znormalize(jnp.asarray(x)))
    got = S.znormalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("L,w,b", CFGS)
def test_interleave_roundtrip_and_oracle(L, w, b):
    rng = np.random.default_rng(b)
    codes = rng.integers(0, 1 << b, (200, w)).astype(np.uint8)
    keys = K.interleave_codes(torch.from_numpy(codes), w=w, b=b)
    back = K.deinterleave_key(keys, w=w, b=b)
    np.testing.assert_array_equal(back.numpy(), codes)
    assert (K.keys_to_bigint(keys.numpy().astype(np.uint32))
            == K.interleave_oracle(codes, w, b))


@pytest.mark.parametrize("L,w,b", CFGS)
def test_lexsort_keys_same_permutation(L, w, b):
    # few distinct codes: many duplicate keys exercise stability
    rng = np.random.default_rng(w * b)
    codes = rng.integers(0, min(4, 1 << b), (3000, w)).astype(np.uint8)
    r_keys = np.array(RK.interleave_codes(jnp.asarray(codes), w=w, b=b))
    perm_ref = np.asarray(RK.lexsort_keys(jnp.asarray(r_keys)))
    perm = K.lexsort_keys(torch.from_numpy(r_keys.astype(np.int64)))
    np.testing.assert_array_equal(perm.numpy(), perm_ref)
    np.testing.assert_array_equal(
        K.lexsort_keys_np(r_keys.astype(np.int64)), perm_ref)


def test_lexsort_keys_full_word_range():
    """Words at the top of [0, 2**32) sort as unsigned values."""
    words = np.array([[0xFFFFFFFF, 0], [0x80000000, 5], [0x7FFFFFFF, 9],
                      [0xFFFFFFFF, 0xFFFFFFFF], [0, 0xFFFFFFFF],
                      [0x80000000, 4], [0, 0]], np.uint32)
    keys = np.concatenate([words, words[::-1]], axis=1)        # 4 words
    perm_ref = np.asarray(RK.lexsort_keys(jnp.asarray(keys)))
    perm = K.lexsort_keys(torch.from_numpy(keys.astype(np.int64)))
    np.testing.assert_array_equal(perm.numpy(), perm_ref)
    odd = keys[:, :3]                                           # 3 words
    np.testing.assert_array_equal(
        K.lexsort_keys(torch.from_numpy(odd.astype(np.int64))).numpy(),
        np.asarray(RK.lexsort_keys(jnp.asarray(odd))))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("L,w,b", CFGS[:2])
def test_searchsorted_keys_same_insertion_points(side, L, w, b):
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 1 << b, (500, w)).astype(np.uint8)
    keys = np.asarray(RK.interleave_codes(jnp.asarray(codes), w=w, b=b))
    keys = keys[np.asarray(RK.lexsort_keys(jnp.asarray(keys)))]
    q_codes = rng.integers(0, 1 << b, (40, w)).astype(np.uint8)
    q_keys = np.asarray(RK.interleave_codes(jnp.asarray(q_codes), w=w, b=b))
    q_keys = np.concatenate([q_keys, keys[::50]])      # exact hits too
    ref = np.asarray(RK.searchsorted_keys(jnp.asarray(keys),
                                          jnp.asarray(q_keys), side=side))
    got = K.searchsorted_keys(torch.from_numpy(keys.astype(np.int64)),
                              torch.from_numpy(q_keys.astype(np.int64)),
                              side=side)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("L,w,b", CFGS[:2])
def test_plain_bounds_and_distances_match_reference(L, w, b):
    x = _walks(300, L, seed=3)
    q = _walks(6, L, seed=4)
    rcfg, cfg = RS.SummaryConfig(L, w, b), S.SummaryConfig(L, w, b)
    _, r_codes = RS.summarize(jnp.asarray(x), rcfg)
    r_codes = np.array(r_codes)
    q_paa = np.array(RS.paa(jnp.asarray(q), w))
    tc, tq = torch.from_numpy(r_codes), torch.from_numpy(q_paa)
    for rfn, fn in ((RS.mindist_sq, S.mindist_sq),
                    (RS.mindist_sq_table, S.mindist_sq_table)):
        np.testing.assert_allclose(
            fn(tq[0], tc, cfg).numpy(),
            np.asarray(rfn(jnp.asarray(q_paa[0]), jnp.asarray(r_codes),
                           rcfg)), rtol=1e-6)
    np.testing.assert_allclose(
        S.mindist_sq_batch(tq, tc, cfg).numpy(),
        np.asarray(RS.mindist_sq_batch(jnp.asarray(q_paa),
                                       jnp.asarray(r_codes), rcfg)),
        rtol=1e-6)
    np.testing.assert_allclose(
        S.euclidean_sq_batch(torch.from_numpy(q), torch.from_numpy(x)).numpy(),
        np.asarray(RS.euclidean_sq_batch(jnp.asarray(q), jnp.asarray(x))),
        rtol=1e-6)
    np.testing.assert_allclose(
        S.euclidean_sq(torch.from_numpy(q[0]), torch.from_numpy(x)).numpy(),
        np.asarray(RS.euclidean_sq(jnp.asarray(q[0]), jnp.asarray(x))),
        rtol=1e-6)
