"""The port's training path against the reference's, on the CPU.

* ``train/optimizer.py``: ``schedule``, ``global_norm`` and
  ``adamw_update`` on the same params, grads and moments.  Against the
  reference run op by op, fp32 is bit for bit and bf16 params and moments
  are within one bf16 ulp (inside the warmup and under the clip, where
  no transcendental or reduction order enters); with the clip active and
  past the warmup, against the jitted reference at rtol 1e-6 (XLA fuses
  the schedule, whose cosine is not PyTorch's to the last bit).
* ``train/compression.py`` with ties at the threshold, bit for bit.
* One train step per architecture, over the ten SMOKE configs with the
  reference's weights carried across by ``params_from_reference``: the
  loss, ``ce`` and the aux losses at rtol = atol = 1e-4, every gradient
  at 1e-4 of its leaf's largest magnitude, and ``adamw_update`` fed the
  port's gradients in both packages (a whole Adam step's sign-like update
  would magnify gradient noise).
* In the port: ``microbatches=2`` is the mean of the two halves' grads
  (and the whole batch's for archs with no batch-level aux loss),
  ``remat=True`` gives the same bits as ``remat=False``, and the
  cotangent of a bf16 model is bf16 at every anchor.
* ``launch/flops.py`` equals the reference's for every config.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.launch import flops as RF
from repro.models.steps import _loss_fn as ref_loss_fn
from repro.models.transformer import make_model as ref_model
from repro.train import compression as RC
from repro.train import optimizer as RO
from repro_torch.configs import ARCHS, get
from repro_torch.launch import flops as PF
from repro_torch.models import (Model, init_train_state, loss_and_grads,
                                make_train_step, params_from_reference)
from repro_torch.models import transformer as TR
from repro_torch.train import compression as PC
from repro_torch.train import optimizer as PO

TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 4, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_bits(a) -> np.ndarray:
    """A bfloat16 array (jax or torch) as int32 of its 16 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


def to_reference(flat, cfg, template):
    """The port's ``{name: tensor}`` as the reference's param tree (the
    inverse of ``params_from_reference``), numpy leaves like
    ``template``'s dtypes."""
    kinds = cfg.layer_kinds()
    pattern = cfg.block_pattern or (kinds[0],)
    n_full = len(kinds) // len(pattern)

    def leaf(name, like):
        t = flat[name]
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(like.dtype)
        return jnp.asarray(t.numpy()).astype(like.dtype)

    def sub(tree, prefix, rows=None):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = sub(v, f"{prefix}{k}.", rows)
            elif rows is None:
                out[k] = leaf(prefix.format() + k, v)
            else:
                out[k] = jnp.stack([leaf(prefix.format(r) + k, v[0])
                                    for r in rows])
        return out

    out = {}
    for name, v in template.items():
        if name == "blocks" or name == "cross":
            out[name] = {}
            for pi, bp in v.items():
                rows = [j * len(pattern) + int(pi) for j in range(n_full)]
                pre = "layers.{}." + ("cross_" if name == "cross" else "")
                out[name][pi] = sub(bp, pre, rows)
        elif name in ("rem", "cross_rem"):
            out[name] = [
                sub(bp, f"layers.{n_full * len(pattern) + li}."
                    + ("cross_" if name == "cross_rem" else ""))
                for li, bp in enumerate(v)]
        elif name == "enc_blocks":
            out[name] = sub(v, "enc_layers.{}.", range(cfg.enc_layers))
        else:
            out[name] = leaf(name, v)
    return out


# ---------------------------------------------------------------------------
# the optimizer and the compression
# ---------------------------------------------------------------------------

def _leaves(rng, dtype, scale=1.0):
    shapes = {"a": (7, 5), "b": (33,), "c": (3, 4, 6)}
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _opt_pair(rng, pdt, mdt, step, gscale):
    p = _leaves(rng, pdt)
    g = _leaves(rng, pdt, gscale)
    m = _leaves(rng, mdt, 0.01)
    v = {k: np.abs(a) for k, a in _leaves(rng, mdt, 1e-4).items()}
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    ref = ({k: jnp.asarray(a).astype(jd[pdt]) for k, a in p.items()},
           {k: jnp.asarray(a).astype(jd[pdt]) for k, a in g.items()},
           {"m": {k: jnp.asarray(a).astype(jd[mdt]) for k, a in m.items()},
            "v": {k: jnp.asarray(a).astype(jd[mdt]) for k, a in v.items()},
            "step": jnp.int32(step)})
    port = ({k: _t(a).to(td[pdt]) for k, a in p.items()},
            {k: _t(a).to(td[pdt]) for k, a in g.items()},
            {"m": {k: _t(a).to(td[mdt]) for k, a in m.items()},
             "v": {k: _t(a).to(td[mdt]) for k, a in v.items()},
             "step": torch.tensor(step, dtype=torch.int32)})
    return ref, port


def _assert_state(rp, ro, pp, po, pdt, mdt):
    for tree_r, tree_p, dt in ((rp, pp, pdt), (ro["m"], po["m"], mdt),
                               (ro["v"], po["v"], mdt)):
        for k in tree_r:
            if dt == "float32":
                np.testing.assert_array_equal(
                    tree_p[k].numpy().view(np.uint32),
                    np.asarray(tree_r[k]).view(np.uint32), err_msg=k)
            else:
                d = np.abs(_bf16_bits(tree_p[k]) - _bf16_bits(tree_r[k]))
                assert d.max() <= 1, (k, d.max())
    assert int(po["step"]) == int(ro["step"])


@pytest.mark.parametrize("pdt,mdt", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("step", [0, 3, 8])
def test_adamw_update_op_by_op(pdt, mdt, step):
    """Inside the warmup (lr = lr * step / warmup, no cosine) and under
    the clip (clip = 1 exactly): the reference's arithmetic, op for op."""
    cfg = RO.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=20,
                         moment_dtype=mdt)
    pcfg = PO.AdamWConfig(**dataclasses.asdict(cfg))
    (rp, rg, ro), (pp, pg, po) = _opt_pair(np.random.default_rng(step), pdt,
                                           mdt, step, gscale=0.02)
    rp2, ro2, rm = RO.adamw_update(rp, rg, ro, cfg)
    pp2, po2, pm = PO.adamw_update(pp, pg, po, pcfg)
    assert float(rm["grad_norm"]) < 1.0
    assert pp2 is pp and all(pp2[k] is pp[k] for k in pp)   # in place
    _assert_state(rp2, ro2, pp2, po2, pdt, mdt)
    assert np.asarray(rm["lr"]).view(np.uint32) == \
        pm["lr"].numpy().view(np.uint32)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-6)


@pytest.mark.parametrize("step", [9, 14, 40])
def test_adamw_update_clipped_after_warmup(step):
    cfg = RO.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=20)
    pcfg = PO.AdamWConfig(**dataclasses.asdict(cfg))
    (rp, rg, ro), (pp, pg, po) = _opt_pair(np.random.default_rng(step),
                                           "float32", "float32", step,
                                           gscale=3.0)
    rp2, ro2, rm = jax.jit(functools.partial(RO.adamw_update, cfg=cfg))(
        rp, rg, ro)
    pp2, po2, pm = PO.adamw_update(pp, pg, po, pcfg)
    assert float(rm["grad_norm"]) > cfg.grad_clip
    for r, p in ((rp2, pp2), (ro2["m"], po2["m"]), (ro2["v"], po2["v"])):
        for k in r:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(r[k]),
                                       rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), rtol=1e-6)


def test_schedule_and_global_norm():
    cfg = RO.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=50)
    pcfg = PO.AdamWConfig(**dataclasses.asdict(cfg))
    steps = np.arange(0, 70)
    ref = np.array([float(RO.schedule(cfg, jnp.int32(s))) for s in steps])
    port = np.array([float(PO.schedule(pcfg, torch.tensor(int(s))))
                     for s in steps])
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    assert port[0] == 0.0 and port[10] == pytest.approx(1e-3)
    assert port[-1] == pytest.approx(1e-4)          # min_lr_frac * lr
    rng = np.random.default_rng(0)
    tree = _leaves(rng, "float32", 3.0)
    np.testing.assert_allclose(
        float(PO.global_norm({k: _t(a) for k, a in tree.items()})),
        float(RO.global_norm({k: jnp.asarray(a) for k, a in tree.items()})),
        rtol=1e-6)
    bf = {k: _t(a).to(torch.bfloat16) for k, a in tree.items()}
    np.testing.assert_allclose(
        float(PO.global_norm(bf)),
        float(RO.global_norm({k: jnp.asarray(a).astype(jnp.bfloat16)
                              for k, a in tree.items()})), rtol=1e-6)


def test_compress_grads_with_ties():
    """Values from a small set: many entries tie with the k-th largest
    ``|a|`` and all of them are kept, as in the reference; over rounds the
    residual and the sent grads agree bit for bit."""
    rng = np.random.default_rng(0)
    grads = {"w": (rng.integers(-4, 5, (40, 30)) * 0.25).astype(np.float32),
             "b": rng.standard_normal(50).astype(np.float32)}
    cfg = RC.CompressionConfig(ratio=0.05, min_k=8)
    pcfg = PC.CompressionConfig(ratio=0.05, min_k=8)
    rg = {k: jnp.asarray(v) for k, v in grads.items()}
    pg = {k: _t(v) for k, v in grads.items()}
    rr, pr = RC.compress_init(rg), PC.compress_init(pg)
    for _ in range(5):
        rc, rr, rs = RC.compress_grads(rg, rr, cfg)
        pc, pr, ps = PC.compress_grads(pg, pr, pcfg)
        for k in grads:
            np.testing.assert_array_equal(pc[k].numpy(), np.asarray(rc[k]))
            np.testing.assert_array_equal(pr[k].numpy(), np.asarray(rr[k]))
        assert float(ps["kept_entries"]) == float(rs["kept_entries"])
        assert ps["total_entries"] == rs["total_entries"]
        assert PC.modeled_wire_bytes(ps) == RC.modeled_wire_bytes(rs)
    # the ties: more than k entries of "w" went out in the first round
    first, _, _ = PC.compress_grads(pg, PC.compress_init(pg), pcfg)
    assert int((first["w"] != 0).sum()) > int(0.05 * 40 * 30)


# ---------------------------------------------------------------------------
# one train step per architecture
# ---------------------------------------------------------------------------

def _batch(cfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_unpadded, (b, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :T], "labels": toks[:, 1:]}
    if cfg.frontend != "none":
        batch["frontend"] = (0.1 * rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    ref = {k: jnp.asarray(v) for k, v in batch.items()}
    port = {k: (_t(v).long() if v.dtype == np.int32 else _t(v))
            for k, v in batch.items()}
    return ref, port


@functools.lru_cache(maxsize=None)
def _ref_grad_fn(arch):
    ref = ref_model(ref_get(arch, smoke=True))
    return ref, jax.jit(jax.value_and_grad(
        functools.partial(ref_loss_fn, model=ref, sh=None, remat=False),
        has_aux=True))


def _assert_grads(pg, rg_flat):
    assert set(pg) == set(rg_flat)
    for k, g in pg.items():
        want = rg_flat[k].float().numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - want).max())
        assert err <= 1e-4 * scale + 1e-7, (k, err, scale)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_matches_reference(arch):
    cfg = get(arch, smoke=True)
    ref, grad_fn = _ref_grad_fn(arch)
    params = ref.init(jax.random.PRNGKey(0))
    port = Model(cfg, device="cpu",
                 params=params_from_reference(_np(params), cfg,
                                              device="cpu"))
    rb, pb = _batch(cfg)
    (r_loss, r_parts), r_grads = grad_fn(params, rb)
    opt_cfg = PO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = init_train_state(port, opt_cfg)
    assert all(p.requires_grad for p in port.parameters())
    p_loss, p_parts, p_grads = loss_and_grads(port, state["params"], pb,
                                              remat=True)
    np.testing.assert_allclose(float(p_loss), float(r_loss), **TOL)
    for key in ("ce", "load_balance", "router_z"):
        np.testing.assert_allclose(float(p_parts[key]),
                                   float(r_parts[key]), **TOL)
    _assert_grads(p_grads, params_from_reference(_np(r_grads), cfg,
                                                 device="cpu"))

    # adamw_update fed the port's gradients, in both packages
    r_opt = RO.adamw_init(params)
    r_new, _, r_om = jax.jit(functools.partial(
        RO.adamw_update, cfg=RO.AdamWConfig(**dataclasses.asdict(opt_cfg))))(
        params, to_reference(p_grads, cfg, params), r_opt)
    p_new, _, p_om = PO.adamw_update(
        {k: v.detach().clone() for k, v in state["params"].items()},
        p_grads, PO.adamw_init(state["params"]), opt_cfg)
    want = params_from_reference(_np(r_new), cfg, device="cpu")
    for k, v in p_new.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=k)
    np.testing.assert_allclose(float(p_om["grad_norm"]),
                               float(r_om["grad_norm"]), rtol=1e-5)

    # the whole step: the reference's metric keys, and its values
    step = make_train_step(port, opt_cfg=opt_cfg, remat=False)
    state, metrics = step(state, pb)
    assert sorted(metrics) == sorted(["loss", "ce", "load_balance",
                                      "router_z", "grad_norm", "lr"])
    np.testing.assert_allclose(float(metrics["loss"]), float(r_loss), **TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(r_om["grad_norm"]), rtol=1e-4)
    assert int(state["opt"]["step"]) == 1
    assert all(state["params"][k] is p for k, p in
               port.named_parameters())       # the model trains in place


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_microbatches_and_remat(arch):
    """Two microbatches give the mean of the two halves' grads (and the
    whole batch's where no aux loss is a batch statistic); remat gives the
    same bits as no remat."""
    cfg = get(arch, smoke=True)
    model = Model(cfg, device="cpu", seed=1)
    params = init_train_state(model)["params"]
    _, pb = _batch(cfg, seed=3)
    l1, _, g1 = loss_and_grads(model, params, pb, remat=False)
    _, _, g1r = loss_and_grads(model, params, pb, remat=True)
    for k in g1:
        assert torch.equal(g1[k], g1r[k]), k
    l2, parts2, g2 = loss_and_grads(model, params, pb, microbatches=2,
                                    remat=True)
    halves = [loss_and_grads(model, params,
                             {k: v[i * B // 2:(i + 1) * B // 2]
                              for k, v in pb.items()}, remat=False)
              for i in range(2)]
    np.testing.assert_allclose(float(l2), float(halves[0][0] + halves[1][0])
                               / 2, rtol=1e-6)
    for k in g2:
        assert g2[k].dtype == torch.float32
        mean = (halves[0][2][k] + halves[1][2][k]) / 2
        np.testing.assert_allclose(g2[k].numpy(), mean.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if cfg.family != "moe":
        np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
        for k in g2:
            scale = float(g1[k].abs().max()) + 1e-30
            assert float((g2[k] - g1[k]).abs().max()) <= 1e-5 * scale, k


def test_bf16_cotangents_at_every_anchor(monkeypatch):
    """A bf16 stack with pattern groups and a remainder layer: the
    cotangent leaving every anchor and the logits' cotangent are bf16,
    anchors sit at the n_full group starts and not on the remainder."""
    cfg = dataclasses.replace(get("recurrentgemma-2b", smoke=True),
                              n_layers=7, param_dtype="bfloat16")
    model = Model(cfg, device="cpu", seed=0)
    assert (len(model.pattern), model.n_full) == (3, 2)
    seen, anchored = [], []
    real = TR.dtype_anchor

    def spy(x):
        # remat calls the group again in the backward, on the same input:
        # one hook a tensor
        if x.requires_grad and not any(x is a for a in anchored):
            anchored.append(x)
            x.register_hook(lambda g: seen.append(g.dtype))
        return real(x)

    monkeypatch.setattr(TR, "dtype_anchor", spy)
    logits_ct = []
    real_logits = model._logits

    def logits_spy(x):
        out = real_logits(x)
        out.register_hook(lambda g: logits_ct.append(g.dtype))
        return out

    monkeypatch.setattr(model, "_logits", logits_spy)
    params = init_train_state(model)["params"]
    _, pb = _batch(cfg)
    for remat in (False, True):
        seen.clear()
        anchored.clear()
        logits_ct.clear()
        _, _, grads = loss_and_grads(model, params, pb, remat=remat)
        assert seen == [torch.bfloat16] * 2 and len(anchored) == 2
        assert logits_ct == [torch.bfloat16]
        assert all(g.dtype == params[k].dtype for k, g in grads.items())


# ---------------------------------------------------------------------------
# the analytic FLOP model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_flops_match_reference(arch):
    for smoke in (False, True):
        cfg, rcfg = get(arch, smoke), ref_get(arch, smoke)
        for B_, T_ in ((8, 1024), (1, 7)):
            for kind in ("train", "prefill", "decode"):
                assert PF.step_flops(cfg, B_, T_, kind) == \
                    RF.step_flops(rcfg, B_, T_, kind)
                assert PF.model_flops_6nd(cfg, B_, T_, kind) == \
                    RF.model_flops_6nd(rcfg, B_, T_, kind)
            assert PF.step_flops(cfg, B_, T_, "train", remat=False) == \
                RF.step_flops(rcfg, B_, T_, "train", remat=False)
            assert PF.forward_flops(cfg, B_, T_) == \
                RF.forward_flops(rcfg, B_, T_)

