"""Port parity: each plain twin of a CUDA kernel vs the reference's Pallas
kernel (run in interpret mode, as ``tests/test_kernels.py`` runs it) and vs
``repro.kernels.ref``.

Both packages get the same numpy inputs.  Tolerances: bounds and distances
at rtol 1e-6 (the port fixes its own float32 summation order, which may
differ from XLA's); indices, counts and the union exact; codes and keys
exact except rows whose reference PAA lies within 4 ulp of a breakpoint.
Within the port, the packed-code bound equals the bound on the decoded
codes bit for bit.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import summarization as RS
from repro.kernels import ref as RR
from repro.kernels.batch_euclid import batch_euclid_pallas
from repro.kernels.fused_build import fused_build_pallas
from repro.kernels.mindist_batch import mindist_batch_pallas
from repro.kernels.mindist_scan import mindist_pallas
from repro.kernels.sax_summarize import sax_summarize_pallas
from repro.kernels.scan_verify import scan_verify_pallas
from repro.kernels.unpack_mindist import unpack_mindist_batch_pallas
from repro.kernels.zorder import zorder_pallas
from repro.storage.packing import pack_codes
from repro_torch.core import summarization as S
from repro_torch.kernels import loader, ops, ref

SHAPES = [(64, 8, 4), (256, 16, 8), (64, 8, 1)]


def _walks(n, L, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((n, L)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


def _finite_bounds(bits):
    lo, hi = RS.region_bounds(bits)
    return (jnp.nan_to_num(lo, neginf=-1e30), jnp.nan_to_num(hi, posinf=1e30))


def _case(n, nq, L, w, b, seed=0):
    x = _walks(n, L, seed)
    q = _walks(nq, L, seed + 1)
    q[: nq // 2] = x[: nq // 2] + 0.1 * np.random.default_rng(seed) \
        .standard_normal((nq // 2, L)).astype(np.float32)
    rcfg = RS.SummaryConfig(L, w, b)
    _, codes = RS.summarize(jnp.asarray(x), rcfg)
    q_paas = np.array(RS.paa(jnp.asarray(q), w))
    return x, q, np.array(codes), q_paas


@pytest.mark.parametrize("nq", [1, 8, 64])
@pytest.mark.parametrize("L,w,b", SHAPES)
def test_mindist_twin_vs_pallas(nq, L, w, b):
    x, q, codes, q_paas = _case(301, nq, L, w, b, seed=nq)
    lo, hi = _finite_bounds(b)
    scale = L / w
    pallas = np.asarray(mindist_batch_pallas(
        jnp.asarray(q_paas), jnp.asarray(codes, jnp.int32), lo, hi,
        scale=scale, block_n=128, interpret=True))
    oracle = np.asarray(RR.mindist_batch_ref(jnp.asarray(q_paas),
                                             jnp.asarray(codes), lo, hi,
                                             scale))
    cfg = S.SummaryConfig(L, w, b)
    got = ops.mindist_batch(torch.from_numpy(q_paas),
                            torch.from_numpy(codes), cfg).numpy()
    np.testing.assert_allclose(got, pallas, rtol=1e-6)
    np.testing.assert_allclose(got, oracle, rtol=1e-6)
    if nq == 1:     # the single-query TPU kernel is the Q = 1 case
        single = np.asarray(mindist_pallas(
            jnp.asarray(q_paas[0]), jnp.asarray(codes, jnp.int32), lo, hi,
            scale=scale, block_n=128, interpret=True))
        np.testing.assert_allclose(
            ops.mindist(torch.from_numpy(q_paas[0]),
                        torch.from_numpy(codes), cfg).numpy(),
            single, rtol=1e-6)
    # and it lower-bounds the true squared distance
    ed = ((x[None] - q[:, None]) ** 2).sum(-1)
    assert np.all(got <= ed * (1 + 1e-5) + 1e-5)


@pytest.mark.parametrize("nq", [1, 8, 64])
@pytest.mark.parametrize("L", [64, 256])
def test_batch_euclid_twin_vs_pallas(nq, L):
    x, q, _, _ = _case(257, nq, L, 8, 4, seed=L)
    got = ops.batch_euclid_multi(torch.from_numpy(q),
                                 torch.from_numpy(x)).numpy()
    oracle = np.asarray(RR.batch_euclid_multi_ref(jnp.asarray(q),
                                                  jnp.asarray(x)))
    np.testing.assert_allclose(got, oracle, rtol=1e-6)
    for qi in range(min(nq, 3)):
        pallas = np.asarray(batch_euclid_pallas(
            jnp.asarray(q[qi]), jnp.asarray(x), block_n=128, interpret=True))
        np.testing.assert_allclose(got[qi], pallas, rtol=1e-6)
        np.testing.assert_array_equal(
            ops.batch_euclid(torch.from_numpy(q[qi]),
                             torch.from_numpy(x)).numpy(), got[qi])
    # gathered form: bit-identical to the cross form on the same pairs
    idx = np.random.default_rng(nq).integers(0, len(x), (nq, 40))
    gat = ops.batch_euclid_multi(torch.from_numpy(q), torch.from_numpy(x),
                                 idx=torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(gat, np.take_along_axis(got, idx, 1))


def test_twins_count_no_launches():
    x, q, codes, q_paas = _case(100, 4, 64, 8, 4)
    cfg = S.SummaryConfig(64, 8, 4)
    before = dict(loader.LAUNCHES)
    ops.mindist_batch(torch.from_numpy(q_paas), torch.from_numpy(codes), cfg)
    ops.batch_euclid_multi(torch.from_numpy(q), torch.from_numpy(x))
    ops.summarize_and_key(torch.from_numpy(x), cfg)
    _, c = ops.sax_summarize(torch.from_numpy(x), cfg)
    ops.zorder(c, cfg)
    ops.mindist_batch_packed(torch.from_numpy(q_paas),
                             torch.from_numpy(pack_codes(codes, 4)), cfg)
    assert dict(loader.LAUNCHES) == before


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("nq", [1, 8])
@pytest.mark.parametrize("L,w,b", SHAPES[:2])
def test_scan_verify_twin_vs_pallas(k, nq, L, w, b):
    n = 300
    x, q, codes, q_paas = _case(n, nq, L, w, b, seed=k + nq)
    ed = ((x[None] - q[:, None]) ** 2).sum(-1)
    bound = np.quantile(ed, 0.3, axis=1).astype(np.float32)
    dead = (np.random.default_rng(k).random(n) < 0.25).astype(np.int32)
    lo, hi = _finite_bounds(b)
    scale = L / w
    args = (jnp.asarray(q), jnp.asarray(q_paas), jnp.asarray(codes),
            jnp.asarray(x), lo, hi, jnp.asarray(bound), jnp.asarray(dead))
    p_d, p_i, p_c, p_u = (np.asarray(a) for a in scan_verify_pallas(
        *args[:2], args[2].astype(jnp.int32), *args[3:], scale=scale, k=k,
        block_n=128, interpret=True))
    o_d, o_i, o_c, o_u = (np.asarray(a) for a in RR.scan_verify_ref(
        *args, scale=scale, k=k))
    cfg = S.SummaryConfig(L, w, b)
    d, i, c, u = ops.scan_verify(
        torch.from_numpy(q), torch.from_numpy(q_paas),
        torch.from_numpy(codes), torch.from_numpy(x),
        torch.from_numpy(bound), cfg, k=k, dead=torch.from_numpy(dead))
    for od, oi, oc, ou in ((p_d, p_i, p_c, p_u), (o_d, o_i, o_c, o_u)):
        np.testing.assert_array_equal(i.numpy(), oi)
        np.testing.assert_array_equal(c.numpy(), oc)
        assert int(u) == int(ou)
        np.testing.assert_allclose(d.numpy(), od, rtol=1e-6)


@pytest.mark.parametrize("L,w,b", SHAPES)
def test_fused_build_twin_vs_pallas(L, w, b):
    x = _walks(513, L, seed=b)
    bps = RS.breakpoints(b)
    p_paa, p_codes, p_keys = (np.asarray(a) for a in fused_build_pallas(
        jnp.asarray(x), bps, segments=w, bits=b, block_n=128,
        interpret=True))
    cfg = S.SummaryConfig(L, w, b)
    paa, codes, keys = ops.summarize_and_key(torch.from_numpy(x), cfg)
    np.testing.assert_allclose(paa.numpy(), p_paa, rtol=1e-6)
    bps_np = RS._breakpoints_np(b)
    near = (np.abs(p_paa[..., None] - bps_np)
            <= 4 * np.spacing(np.abs(bps_np))).any(axis=(-1, -2))
    np.testing.assert_array_equal(codes.numpy()[~near], p_codes[~near])
    np.testing.assert_array_equal(keys.numpy()[~near],
                                  p_keys[~near].astype(np.int64))
    assert codes.dtype == torch.uint8 and keys.dtype == torch.int64


PACK_SHAPES = [(64, 8, b) for b in (1, 3, 4, 5)] + [(256, 16, 8)]


def _near_breakpoint(paa, b):
    bps = RS._breakpoints_np(b)
    return (np.abs(paa[..., None] - bps)
            <= 4 * np.spacing(np.abs(bps))).any(axis=(-1, -2))


@pytest.mark.parametrize("L,w,b", PACK_SHAPES)
def test_sax_summarize_twin_vs_pallas(L, w, b):
    x = _walks(401, L, seed=10 + b)
    p_paa, p_codes = (np.asarray(a) for a in sax_summarize_pallas(
        jnp.asarray(x), RS.breakpoints(b), segments=w, block_n=128,
        interpret=True))
    paa, codes = ops.sax_summarize(torch.from_numpy(x),
                                   S.SummaryConfig(L, w, b))
    np.testing.assert_allclose(paa.numpy(), p_paa, rtol=1e-6)
    near = _near_breakpoint(p_paa, b)
    np.testing.assert_array_equal(codes.numpy()[~near], p_codes[~near])
    assert codes.dtype == torch.uint8


@pytest.mark.parametrize("L,w,b", PACK_SHAPES)
def test_zorder_twin_vs_pallas(L, w, b):
    codes = np.random.default_rng(b).integers(0, 1 << b, (300, w))
    want = np.asarray(zorder_pallas(jnp.asarray(codes, jnp.int32), w=w, b=b,
                                    block_n=128, interpret=True))
    got = ops.zorder(torch.from_numpy(codes.astype(np.uint8)),
                     S.SummaryConfig(L, w, b))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(RR.zorder_ref(jnp.asarray(codes), w=w, b=b))
        .astype(np.int64))


@pytest.mark.parametrize("nq", [1, 8, 64])
@pytest.mark.parametrize("L,w,b", PACK_SHAPES)
def test_unpack_mindist_twin_vs_pallas(nq, L, w, b):
    x, q, codes, q_paas = _case(301, nq, L, w, b, seed=nq + b)
    packed = pack_codes(codes.astype(np.uint8), b)
    lo, hi = _finite_bounds(b)
    pallas = np.asarray(unpack_mindist_batch_pallas(
        jnp.asarray(q_paas), jnp.asarray(packed), lo, hi, w=w, b=b,
        scale=L / w, block_n=128, interpret=True))
    cfg = S.SummaryConfig(L, w, b)
    got = ops.mindist_batch_packed(torch.from_numpy(q_paas),
                                   torch.from_numpy(packed), cfg)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-6)
    # packed == unpacked within the port, bit for bit
    unpacked = ops.mindist_batch(torch.from_numpy(q_paas),
                                 torch.from_numpy(codes.astype(np.uint8)),
                                 cfg)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  unpacked.numpy().view(np.uint32))
    lower, upper = S.region_bounds(b)
    np.testing.assert_array_equal(
        ref.mindist_batch_packed_ref(
            torch.from_numpy(q_paas), torch.from_numpy(packed), lower, upper,
            L / w, w=w, b=b).numpy().view(np.uint32),
        ref.mindist_batch_ref(torch.from_numpy(q_paas),
                              torch.from_numpy(codes.astype(np.uint8)),
                              lower, upper, L / w).numpy().view(np.uint32))
    assert np.all(got.numpy() <= ((x[None] - q[:, None]) ** 2).sum(-1)
                  * (1 + 1e-5) + 1e-5)
