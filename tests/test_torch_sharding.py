"""The port's pod tooling against the reference's, on the CPU.

* ``launch/sharding.py``: for all ten archs at full width
  (``resolve_for_tp(16)``) on abstract meshes ``(16, 16)``,
  ``(2, 16, 16)``, ``(2, 2)`` and ``(1, 1)``, under the ``tp`` and ``dp``
  policies: the ``make_shardings`` rules of every mode, and the param,
  train-state, batch and decode-cache placements, leaf for leaf against
  the reference's ``PartitionSpec``s converted here.  The reference's
  leaves are layer-stacked; its spec of a stacked leaf is compared with
  its leading (layer) entry removed.  Three readings of a spec hold on
  both sides: several axes on one dim shard it in mesh order, an axis of
  one device replicates (sharding over one device is the whole dim), and
  the port's multi-pod mesh (``launch.mesh.pod_dims``) has ``('pod',
  'data')`` as one dim of their product's size (the same rows on the same
  ranks).
* ``configs/shapes.py``: ``SHAPES``, ``applicable`` and ``skip_reason``
  (32 runnable cells); ``input_specs`` and ``Model.decode_cache_specs``
  shapes and dtypes, per layer, for every arch x shape.  The one named
  divergence: token and label ids are int64 here (the reference's are
  int32), as every port entry point takes them.
* ``launch/hlo.py``: ``_accounting`` for every op at g in {1, 2, 4, 16}.

The process-group parts (meshes, a sharded step, the dry run) are in
``tests/test_torch_dryrun.py``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as RefMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get as ref_get
from repro.configs import shapes as RSH
from repro.launch import hlo as RH
from repro.launch import sharding as RS
from repro.models.transformer import Model as RefModel
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro_torch.configs import ARCHS, get
from repro_torch.configs import shapes as PSH
from repro_torch.launch import hlo as PH
from repro_torch.launch import mesh as PM
from repro_torch.launch import sharding as PS
from repro_torch.models import Model

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
POLICIES = ("tp", "dp")


def _meshes(key):
    shape, names = MESHES[key]
    return RefMesh(shape, names), PS.AbstractMesh(*PM.pod_dims(shape, names))


def _mesh_dims(shape, names):
    """The port's mesh dims as (pod axes, size): ``pod`` and ``data``
    merged into one dim, every other axis its own."""
    dims = []
    for a, n in zip(names, shape):
        if a == "data" and dims and dims[-1][0] == ("pod",):
            dims[-1] = (("pod", "data"), dims[-1][1] * n)
        else:
            dims.append(((a,), n))
    return dims


def _placements(spec, shape, names):
    """A reference ``PartitionSpec`` as DTensor placements on the port's
    mesh, independently of the port: its dim i is Shard(d) where the
    spec puts its axes on dim d (a dim of one device replicates).  The
    reference never splits ``('pod', 'data')``: a spec holds both or
    neither."""
    dims = _mesh_dims(shape, names)
    out = [Replicate()] * len(dims)
    for d, ax in enumerate(spec):
        axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
        for i, (group, n) in enumerate(dims):
            held = [a in axes for a in group]
            assert all(held) or not any(held), (spec, group)
            if all(held) and n > 1:
                out[i] = Shard(d)
    return tuple(out)


def _spec(x):
    return x.spec if isinstance(x, NamedSharding) else x


def _is_leaf(x):
    return isinstance(x, (P, NamedSharding))


def _ref_by_name(tree, cfg) -> dict:
    """The reference's params (or spec) tree as ``{port name: leaf}``,
    each stacked leaf once per layer (the tree's leaf itself: the caller
    strips the layer entry), after ``params_from_reference``'s naming."""
    kinds = cfg.layer_kinds()
    pattern = cfg.block_pattern or (kinds[0],)
    n_full = len(kinds) // len(pattern)
    out = {}

    def flat(t, prefix, stacked):
        for k, v in t.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}.", stacked)
            else:
                out[prefix + k] = (v, stacked)

    for name in ("embed", "unembed", "final_norm", "frontend_adapter",
                 "enc_norm"):
        if name in tree:
            out[name] = (tree[name], False)
    for j in range(n_full):
        for pi in range(len(pattern)):
            layer = j * len(pattern) + pi
            flat(tree["blocks"][str(pi)], f"layers.{layer}.", True)
            if cfg.is_encdec:
                flat(tree["cross"][str(pi)], f"layers.{layer}.cross_", True)
    for li, bp in enumerate(tree["rem"]):
        layer = n_full * len(pattern) + li
        flat(bp, f"layers.{layer}.", False)
        if cfg.is_encdec:
            flat(tree["cross_rem"][li], f"layers.{layer}.cross_", False)
    if cfg.is_encdec:
        for i in range(cfg.enc_layers):
            flat(tree["enc_blocks"], f"enc_layers.{i}.", True)
    return out


def _ref_placements(tree, cfg, shape, names) -> dict:
    return {k: _placements(tuple(_spec(s))[1:] if stacked
                           else tuple(_spec(s)), shape, names)
            for k, (s, stacked) in _ref_by_name(tree, cfg).items()}


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    cfg = ref_get(arch).resolve_for_tp(16)
    params = jax.eval_shape(RefModel(cfg).init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(lambda p: ref_adamw_init(p, "float32"), params)
    return cfg, params, opt


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    cfg = get(arch).resolve_for_tp(16)
    return cfg, Model(cfg, device="meta")


# ---------------------------------------------------------------------------
# the rule engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_make_shardings_rules(mesh_key):
    ref_mesh, mesh = _meshes(mesh_key)
    for mode in ("baseline", "lean", "dp", "decode2d"):
        for sp in (True, False):
            for shardable in (True, False):
                kw = dict(sp=sp, batch_shardable=shardable, mode=mode)
                assert PS.make_shardings(mesh, **kw).rules == \
                    RS.make_shardings(ref_mesh, **kw).rules, (mode, kw)
    assert PS.make_shardings(None) is None


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_state_batch_cache_placements(arch, mesh_key):
    ref_mesh, mesh = _meshes(mesh_key)
    shape, names = MESHES[mesh_key]
    rcfg, rparams, ropt = _ref_tree(arch)
    cfg, model = _port_model(arch)
    state = {"params": dict(model.named_parameters()),
             "opt": {"m": dict(model.named_parameters()),
                     "v": dict(model.named_parameters()),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device="meta")}}
    for policy in POLICIES:
        want = _ref_placements(RS.param_pspecs(rparams, ref_mesh, policy),
                               rcfg, shape, names)
        got = PS.param_placements(model, mesh, policy)
        assert got == want, (policy, {k for k in want
                                      if got.get(k) != want[k]})
        rstate = RS.state_shardings({"params": rparams, "opt": ropt},
                                    ref_mesh, policy)
        pstate = PS.state_placements(state, mesh, policy)
        for part in ("m", "v"):
            assert pstate["opt"][part] == _ref_placements(
                rstate["opt"][part], rcfg, shape, names), (policy, part)
        assert pstate["params"] == _ref_placements(
            rstate["params"], rcfg, shape, names)
        assert pstate["opt"]["step"] == _placements(
            rstate["opt"]["step"].spec, shape, names)
        for shape_name, ss in PSH.SHAPES.items():
            if not PSH.applicable(cfg, shape_name) or ss.step == "decode":
                continue
            _, rkw = RSH.input_specs(rcfg, shape_name)
            _, pkw = PSH.input_specs(cfg, shape_name)
            rb = RS.batch_pspec(ref_mesh, rkw["batch"], ss.global_batch,
                                policy)
            pb = PS.batch_placements(mesh, pkw["batch"], ss.global_batch,
                                     policy)
            assert pb == {k: _placements(v.spec, shape, names)
                          for k, v in rb.items()}, (policy, shape_name)
    # the decode cache (the reference takes no policy for it)
    for shape_name, ss in PSH.SHAPES.items():
        if not PSH.applicable(cfg, shape_name) or ss.step != "decode":
            continue
        _, rkw = RSH.input_specs(rcfg, shape_name)
        _, pkw = PSH.input_specs(cfg, shape_name)
        B = ss.global_batch
        rc = RS.cache_pspecs(ref_mesh, rkw["cache"], rcfg, B)
        pc = PS.cache_placements(mesh, pkw["cache"], cfg, B)
        assert pc["memory"] == (
            None if rc["memory"] is None
            else _placements(rc["memory"].spec, shape, names))
        _check_cache(rc, pc["layers"], rcfg, shape, names, strip=True)
        tok = PS.batch_placements(mesh, pkw["tokens"], B)
        assert tok == _placements(
            RS.batch_pspec(ref_mesh, rkw["tokens"], B).spec, shape, names)


def _check_cache(ref, layers, cfg, shape, names, strip):
    """The reference's ``{"stacked", "rem"}`` cache tree against the port's
    per-layer list (layer ``j * P + pi`` is row ``j`` of position
    ``pi``)."""
    kinds = cfg.layer_kinds()
    pattern = cfg.block_pattern or (kinds[0],)
    n_full = len(kinds) // len(pattern)

    def leaves(t):
        return [x for x in jax.tree.leaves(t, is_leaf=_is_leaf)]

    for j in range(n_full):
        for pi in range(len(pattern)):
            want = [_placements(tuple(_spec(s))[1:] if strip else _spec(s),
                                shape, names)
                    for s in leaves(ref["stacked"][pi])]
            got = jax.tree.leaves(layers[j * len(pattern) + pi],
                                  is_leaf=lambda x: isinstance(x, tuple)
                                  and x and not isinstance(x[0], tuple))
            assert list(got) == want, (j, pi)
    for li, st in enumerate(ref["rem"]):
        want = [_placements(_spec(s), shape, names) for s in leaves(st)]
        got = jax.tree.leaves(layers[n_full * len(pattern) + li],
                              is_leaf=lambda x: isinstance(x, tuple)
                              and x and not isinstance(x[0], tuple))
        assert list(got) == want, li


def test_spec_order_and_act_on_plain_tensors():
    # ('pod', 'data') is one dim of the multi-pod mesh: one Shard on it
    mesh = PS.AbstractMesh(*PM.pod_dims((2, 2, 2), ("pod", "data", "model")))
    assert mesh == PS.AbstractMesh((4, 2), ("pod+data", "model"))
    assert PS.spec_to_placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(1))
    assert PS.spec_to_placements((None, ("pod", "data", "model")),
                                 mesh) == (Shard(1), Shard(1))
    with pytest.raises(AssertionError):
        PS.spec_to_placements((("data", "pod"),), mesh)
    # one of the two alone is not a dim of the mesh
    with pytest.raises(AssertionError):
        PS.spec_to_placements(("data",), mesh)
    # nor are the two as dims of their own
    with pytest.raises(ValueError, match="make_pod_mesh"):
        PS.spec_to_placements((("pod", "data"),), PS.AbstractMesh(
            (2, 2, 2), ("pod", "data", "model")))
    single = PS.AbstractMesh((2, 2), ("data", "model"))
    assert PM.pod_dims((2, 2), ("data", "model")) == ((2, 2),
                                                      ("data", "model"))
    assert PS.spec_to_placements((("data", "model"),), single) == (
        Shard(0), Shard(0))
    sh = PS.make_shardings(mesh)
    x = torch.ones(4, 4)
    assert sh.act(x, "batch", "seq") is x and sh.whole(x) is x


# ---------------------------------------------------------------------------
# the shapes
# ---------------------------------------------------------------------------

def test_shapes_table_and_applicability():
    assert {k: dataclasses.astuple(v) for k, v in PSH.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in RSH.SHAPES.items()}
    runnable = 0
    for arch in ARCHS:
        for s in PSH.SHAPES:
            assert PSH.applicable(get(arch), s) == \
                RSH.applicable(ref_get(arch), s)
            assert PSH.skip_reason(get(arch), s) == \
                RSH.skip_reason(ref_get(arch), s)
            runnable += PSH.applicable(get(arch), s)
    assert runnable == 32


_DTYPES = {"int32": torch.int64,            # the named divergence
           "bfloat16": torch.bfloat16, "float32": torch.float32}


def _same(ref_sds, t, strip=False):
    shape = tuple(ref_sds.shape)[1:] if strip else tuple(ref_sds.shape)
    return tuple(t.shape) == shape and t.device.type == "meta" \
        and t.dtype == _DTYPES[str(ref_sds.dtype)]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_and_decode_cache_specs(arch):
    cfg = get(arch).resolve_for_tp(16)
    rcfg = ref_get(arch).resolve_for_tp(16)
    for shape_name in PSH.SHAPES:
        if not PSH.applicable(cfg, shape_name):
            with pytest.raises(ValueError):
                PSH.input_specs(cfg, shape_name)
            continue
        rkind, rkw = RSH.input_specs(rcfg, shape_name)
        kind, kw = PSH.input_specs(cfg, shape_name)
        assert kind == rkind
        if kind != "decode":
            assert set(kw["batch"]) == set(rkw["batch"])
            for k, v in kw["batch"].items():
                assert _same(rkw["batch"][k], v), (shape_name, k)
            continue
        assert _same(rkw["tokens"], kw["tokens"])
        assert kw["pos"] == PSH.SHAPES[shape_name].seq_len - 1
        rc, pc = rkw["cache"], kw["cache"]
        assert (rc["memory"] is None) == (pc["memory"] is None)
        if rc["memory"] is not None:
            assert _same(rc["memory"], pc["memory"])
        kinds = cfg.layer_kinds()
        pattern = cfg.block_pattern or (kinds[0],)
        n_full = len(kinds) // len(pattern)
        assert len(pc["layers"]) == len(kinds)
        for layer, st in enumerate(pc["layers"]):
            if layer < n_full * len(pattern):
                ref, strip = rc["stacked"][layer % len(pattern)], True
            else:
                ref, strip = rc["rem"][layer - n_full * len(pattern)], False
            got, want = jax.tree.leaves(st), jax.tree.leaves(ref)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert _same(w, g, strip), (shape_name, layer)


# ---------------------------------------------------------------------------
# collective accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", (1, 2, 4, 16))
@pytest.mark.parametrize("op", ("all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute"))
def test_accounting(op, g):
    for nbytes in (0, 4, 1 << 20, 3 * 7 * 11):
        assert PH._accounting(op, nbytes, g) == \
            RH._accounting(op, nbytes, g)
