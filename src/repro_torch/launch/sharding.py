"""Sharding-rule engine: logical axes -> mesh axes for params, activations,
optimizer state and dry-run inputs, as DTensor placements.

Parallelism mapping, as in the reference:
  * DP     — batch over ('pod', 'data')
  * FSDP   — every weight's non-TP dim over ('pod', 'data') (ZeRO-3)
  * TP     — heads / mlp-hidden / vocab / rnn-width over 'model'
  * SP     — residual-stream sequence over 'model' between blocks
  * EP     — MoE experts over 'model'

The rules are the reference's, table for table.  A spec is what a
``PartitionSpec`` holds: one entry a tensor dim, each ``None``, a mesh
axis name or a tuple of them.  It becomes DTensor placements, one a mesh
dim: mesh dim ``i`` is ``Shard(d)`` where the spec puts axis ``i`` on
tensor dim ``d``, else ``Replicate()``.  Several axes on one tensor dim
(``('pod', 'data')``, the dp policy's ``('pod', 'data', 'model')``) are
sharded major to minor in mesh order, which is JAX's order only while the
tuple is in mesh order; :func:`spec_to_placements` asserts that it is.

Parameter specs come from leaf *names*: a leaf's rule is the last
component of its dotted state-dict name, and ``moe`` anywhere in the name
selects the MoE table.  The rule applies to the trailing dims (the
reference's stacked ``[n_layers, ...]`` leaves get a leading ``None``; the
port's per-layer leaves need none), and a sharding that does not divide
its dim is dropped.

A mesh here is anything with ``mesh_dim_names`` and ``shape``: a
``DeviceMesh``, or an :class:`AbstractMesh` when only the rules are wanted
(the counterpart of the reference's ``AbstractMesh``; no process
group).  A multi-pod mesh is laid out by :func:`launch.mesh.pod_dims`,
``('pod', 'data')`` one dim: a spec's ``('pod', 'data')`` is one
``Shard`` on it, the same rows on the same ranks as the reference's two
axes.  The models take :data:`UNSHARDED`, a ``Shardings`` without a
mesh, by default: each of its methods is then the plain call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, \
    distribute_tensor

from .mesh import dim_axes, fsdp_axes, tp_axis

if TYPE_CHECKING:     # the models import this module
    from ..models.config import ModelConfig

__all__ = ["AbstractMesh", "Shardings", "UNSHARDED", "make_shardings",
           "spec_to_placements", "param_placements", "state_placements",
           "batch_placements", "cache_placements", "shard_state"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, without devices or a process group."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def _axes(mesh) -> Tuple[Tuple[str, ...], str]:
    return fsdp_axes(mesh), tp_axis(mesh)


def _dims(mesh, ax) -> list:
    """The mesh dims a spec entry (``None``, an axis or a tuple of them)
    shards over: whole dims, in mesh order."""
    axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
    groups = dim_axes(mesh)
    idx = sorted({i for a in axes for i, g in enumerate(groups) if a in g})
    assert sum((groups[i] for i in idx), ()) == axes, \
        f"axes {axes} are not whole dims of {mesh.mesh_dim_names} in order"
    return idx


def _size(mesh, ax) -> int:
    return math.prod(mesh.shape[i] for i in _dims(mesh, ax))


def _fit(shape, spec, mesh) -> tuple:
    """Drop a sharding that does not divide its dim (or spans one
    device)."""
    return tuple(ax if _size(mesh, ax) > 1 and n % _size(mesh, ax) == 0
                 else None for n, ax in zip(shape, spec))


def spec_to_placements(spec, mesh) -> tuple:
    """A ``PartitionSpec``-like tuple as one placement a mesh dim.  An
    axis of one device replicates: its shard is the whole dim, and DTensor
    refuses to view a dim it holds sharded."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, ax in enumerate(spec):
        for i in _dims(mesh, ax):
            assert isinstance(out[i], Replicate), \
                f"mesh dim {mesh.mesh_dim_names[i]} shards two dims of {spec}"
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass
class Shardings:
    """Activation-constraint helper threaded through the model code.  With
    ``mesh`` None (:data:`UNSHARDED`) every method is the plain call."""
    mesh: Any
    rules: Dict[str, Any]

    def spec(self, ndim: int, *logical) -> tuple:
        spec = [self.rules.get(ax) if ax else None for ax in logical]
        return tuple(spec + [None] * (ndim - len(spec)))

    def act(self, x, *logical):
        """The counterpart of ``with_sharding_constraint``: a DTensor is
        redistributed to the logical axes' placements; a plain tensor is
        returned as it is.  A sharding that does not divide its dim is
        dropped, as for the parameters: DTensor's view ops refuse uneven
        shards (a SMOKE config's one KV head over two ranks)."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        spec = _fit(x.shape, self.spec(x.ndim, *logical), self.mesh)
        want = spec_to_placements(spec, self.mesh)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    def placements(self, shape, *logical) -> Optional[tuple]:
        """The placements :meth:`act` lays a tensor of ``shape`` out by
        (None without a mesh)."""
        if self.mesh is None:
            return None
        return spec_to_placements(
            _fit(tuple(shape), self.spec(len(shape), *logical), self.mesh),
            self.mesh)

    def leading(self, x, n: int) -> Optional[tuple]:
        """``x``'s own placements as far as they shard its first ``n``
        dims, replicated elsewhere (a plain tensor's: replicated): the
        layout of operands that share those dims with it."""
        if self.mesh is None:
            return None
        pls = getattr(x, "placements", None) or self.placements(x.shape)
        return tuple(pl if isinstance(pl, Shard) and pl.dim < n
                     else Replicate() for pl in pls)

    def scope(self):
        """The context a step runs in: under a mesh (DTensor weights)
        plain tensors made inside the model (positions, masks, zeros)
        join DTensor ops as replicated (``implicit_replication``)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()

    def local(self, fn, out, *pairs):
        """``fn`` on each rank's local shards: the counterpart of a
        ``shard_map`` over dims ``fn`` is independent along, for ops whose
        DTensor form merges two sharded dims (a batched matmul over
        batch x heads, which DTensor's views refuse in some torch
        versions).  Each ``(tensor, placements)`` pair is laid out so
        first, ``fn`` gets the local tensors, and its result is a DTensor
        of placements ``out`` (a list of placements: a tuple of results,
        one each).  An input replicated over a mesh dim that shards the
        result (a weight beside a batch-sharded activation) has its
        gradient there a partial sum: each rank's rows contribute theirs.
        With no DTensor among the tensors ``fn`` runs on them as they
        are."""
        tensors = [t for t, _ in pairs]
        if self.mesh is None or not any(isinstance(t, DTensor)
                                        for t in tensors):
            return fn(*tensors)
        outs = out if isinstance(out, list) else [out]
        split = [any(not isinstance(o[i], Replicate) for o in outs)
                 for i in range(self.mesh.ndim)]
        shards = []
        for t, pl in pairs:
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, self.mesh,
                                       [Replicate()] * self.mesh.ndim,
                                       run_check=False)
            if tuple(t.placements) != tuple(pl):
                t = t.redistribute(self.mesh, pl)
            grads = tuple(Partial() if s and isinstance(p, Replicate) else p
                          for p, s in zip(pl, split))
            shards.append(t.to_local(grad_placements=grads))
        res = fn(*shards)
        if isinstance(out, list):        # several results, placements each
            return tuple(DTensor.from_local(r, self.mesh, o, run_check=False)
                         for r, o in zip(res, out))
        return DTensor.from_local(res, self.mesh, out, run_check=False)

    def whole(self, x):
        """``x`` replicated over the mesh, as its plain whole tensor (each
        rank's copy): for an op DTensor cannot place.  A plain tensor is
        returned as it is."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        return self.act(x).to_local()

    def like(self, t, ref, dtype):
        """``t`` laid out as ``ref`` is, a partial sum reduced in
        ``dtype`` (a plain tensor, or one laid out so already, as it
        is): a gradient on its parameter's shards."""
        if self.mesh is None or not isinstance(t, DTensor) or \
                tuple(t.placements) == tuple(ref.placements):
            return t
        return t.to(dtype).redistribute(ref.device_mesh, ref.placements)

    @staticmethod
    def summed(placements, axis):
        """``placements`` with the mesh dim of ``axis`` (what
        :meth:`axis_of` returns) a partial sum: the layout of a result of
        which each rank along that dim holds a part, the parts to be
        added (``placements`` as they are where ``axis`` is None)."""
        if axis is None:
            return placements
        return tuple(Partial() if j == axis[1] else p
                     for j, p in enumerate(placements))

    def axis_of(self, placements, dim: int):
        """``(mesh, i)`` of the one mesh dim that shards tensor dim ``dim``
        under ``placements``, or None where none does (no mesh, or the
        dim whole): the group a collective over that dim's shards runs
        in."""
        if self.mesh is None or placements is None:
            return None
        idx = [i for i, p in enumerate(placements)
               if isinstance(p, Shard) and p.dim == dim]
        assert len(idx) <= 1, f"dim {dim} over several mesh dims"
        return (self.mesh, idx[0]) if idx else None


# the models' default: no mesh, every method the plain call
UNSHARDED = Shardings(None, {})


def make_shardings(mesh, *, sp: bool = True, batch_shardable: bool = True,
                   mode: str = "baseline") -> Optional[Shardings]:
    """Build activation rules.

    ``sp=False`` for decode (seq dim == 1); ``batch_shardable=False`` when
    global batch < DP degree (long_500k).

    Modes:
      * baseline — constraint on every logical axis (forces explicit
        reshards at each transition).
      * lean     — constraints only where propagation needs help:
        batch/seq on the residual stream, experts for EP, vocab for the
        logits.  Intra-attention/mlp layouts are left to propagation.
      * dp       — pure data parallelism: batch over ALL mesh axes, no TP
        constraints at all (small archs; no TP activation collectives).
      * decode2d — weight-stationary decode: the residual feature dim over
        the FSDP axes, so each matmul contracts matching sharded dims.
    """
    if mesh is None:
        return None
    fsdp, tp = _axes(mesh)
    if mode == "dp":
        all_axes = tuple(fsdp) + (tp,)
        rules = {
            "batch": all_axes if batch_shardable else None,
            "seq": None, "seq_unsharded": None, "embed": None,
            "heads": None, "kv_heads": None, "mlp": None,
            "vocab": None, "experts": None, "rnn": None,
        }
        return Shardings(mesh, rules)
    if mode == "decode2d":
        rules = {
            "batch": None,   # batch stays with the replicated token dim
            "seq": None, "seq_unsharded": None,
            "embed": fsdp,
            "heads": tp, "kv_heads": tp, "mlp": tp,
            "vocab": tp, "experts": tp, "rnn": tp,
        }
        return Shardings(mesh, rules)
    rules = {
        "batch": fsdp if batch_shardable else None,
        "seq": tp if sp else None,
        "seq_unsharded": None,
        "embed": None,
        "heads": tp if mode == "baseline" else None,
        "kv_heads": tp if mode == "baseline" else None,
        "mlp": tp if mode == "baseline" else None,
        "vocab": tp,
        "experts": tp,
        "rnn": tp if mode == "baseline" else None,
    }
    return Shardings(mesh, rules)


# ---------------------------------------------------------------------------
# parameter specs by leaf name (trailing-dims convention)
# ---------------------------------------------------------------------------

def _leaf_rule(name: str, fsdp, tp) -> Optional[Tuple]:
    """Spec entries for the *trailing* dims of a named leaf."""
    F, M = fsdp, tp
    table = {
        # embeddings
        "embed": (M, F),             # [V, d] vocab-parallel
        "unembed": (F, M),           # [d, V]
        "frontend_adapter": (F, None),
        # attention
        "wq": (F, M), "wk": (F, M), "wv": (F, M),
        "bq": (M,), "bk": (M,), "bv": (M,),
        "wo": (M, F),
        # dense mlp
        "w_gate": (F, M), "w_up": (F, M), "w_down": (M, F),
        # norms / small vectors
        "norm1": (None,), "norm2": (None,), "norm": (None,),
        "final_norm": (None,), "enc_norm": (None,),
        # moe (experts over model)
        "router": (F, None),
        # ssm
        "in_proj": (F, None),
        "conv_w": (None, None), "conv_b": (None,),
        "A_log": (M,), "D": (M,), "dt_bias": (M,),
        "out_proj": (M, F),
        # rg-lru
        "w_in_x": (F, M), "w_in_y": (F, M),
        "w_a": (None, M), "b_a": (M,), "w_x": (None, M), "b_x": (M,),
        "Lambda": (M,),
        "w_out": (M, F),
    }
    return table.get(name)


def _moe_leaf_rule(name: str, fsdp, tp) -> Optional[Tuple]:
    """Inside a `moe` subtree experts own the model axis."""
    F, M = fsdp, tp
    table = {
        "w_gate": (M, F, None), "w_up": (M, F, None),
        "w_down": (M, None, F),
        "router": (F, None),
    }
    return table.get(name)


def _named(tree) -> Dict[str, torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def _param_specs(params, mesh, policy: str = "tp") -> Dict[str, tuple]:
    """``{name: spec}`` of a model's (or a ``{name: tensor}`` dict's)
    parameters.

    ``policy="dp"``: no tensor parallelism — every weight is FSDP-sharded
    over ALL mesh axes (gathered transiently per layer); right for archs
    whose largest layer fits one device."""
    fsdp, tp = _axes(mesh)
    if policy == "dp":
        fsdp = tuple(fsdp) + (tp,)
        tp = None

    def spec_for(name: str, shape) -> tuple:
        names = name.split(".")
        leaf_name = names[-1]
        ndim = len(shape)
        rule = None
        if "moe" in names:
            rule = _moe_leaf_rule(leaf_name, fsdp, tp)
        if rule is None:
            rule = _leaf_rule(leaf_name, fsdp, tp)
        if rule is None:
            rule = (None,) * ndim
        lead = ndim - len(rule)
        if lead < 0:
            rule = rule[-ndim:] if ndim else ()
            lead = 0
        spec = (None,) * lead + tuple(rule)
        # drop shardings that do not divide the dim (e.g. tiny smoke configs)
        return _fit(shape, spec, mesh)

    return {k: spec_for(k, tuple(v.shape)) for k, v in _named(params).items()}


def param_placements(params, mesh, policy: str = "tp") -> Dict[str, tuple]:
    """``{name: placements}`` of a model's (or a state dict's) parameters."""
    return {k: spec_to_placements(s, mesh)
            for k, s in _param_specs(params, mesh, policy).items()}


def state_placements(state, mesh, policy: str = "tp") -> dict:
    """Placements of a train state ``{"params", "opt": {"m", "v",
    "step"}}``: the moments mirror the params; the step is replicated."""
    return {
        "params": param_placements(state["params"], mesh, policy),
        "opt": {"m": param_placements(state["opt"]["m"], mesh, policy),
                "v": param_placements(state["opt"]["v"], mesh, policy),
                "step": spec_to_placements((), mesh)},
    }


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def batch_placements(mesh, batch, global_batch: int, policy: str = "tp"):
    """Shard batch dims over DP axes (replicate if not divisible); the
    same tree as ``batch`` with placements at its leaves."""
    fsdp, tp = _axes(mesh)
    if policy == "dp":
        fsdp = tuple(fsdp) + (tp,)
    ax = fsdp if global_batch % _size(mesh, fsdp) == 0 else None
    return _tree_map(lambda leaf: spec_to_placements(
        (ax,) + (None,) * (leaf.ndim - 1), mesh), batch)


def cache_placements(mesh, cache, cfg: ModelConfig, global_batch: int):
    """Decode-cache placements: batch over DP, heads/state over model; the
    same tree as ``cache`` with placements at its leaves.

    The port's cache is per layer (``{"layers": [state per layer],
    "memory"}``): attn (k|v) [B, S, KV, D]; ssm conv [B, K, C] + state
    [B, H, P, S]; rec conv [B, K, r] + state [B, r]; cross k/v [B, Senc,
    KV, D]; memory [B, Senc, d].  The batch dim is the first dim equal to
    ``global_batch``, as the reference finds it on its layer-stacked
    leaves."""
    fsdp, tp = _axes(mesh)
    b_ax = fsdp if global_batch % _size(mesh, fsdp) == 0 else None
    tp_n = _size(mesh, tp)
    candidates = {cfg.n_kv_heads, cfg.ssm_heads if cfg.ssm_state else -1,
                  cfg.rnn_width_ if cfg.family == "hybrid" else -1,
                  cfg.d_model}

    def placements(leaf):
        shape = tuple(leaf.shape)
        dims = [None] * len(shape)
        b_i = shape.index(global_batch) if global_batch in shape else None
        if b_i is not None:
            dims[b_i] = b_ax
        # shard the "heads-like" dim over model: the trailing dim whose
        # size is divisible by tp and matches a known head count
        for i in range(len(shape) - 1, (b_i if b_i is not None else -1), -1):
            if dims[i] is None and shape[i] in candidates \
                    and shape[i] % tp_n == 0:
                dims[i] = tp
                break
        return spec_to_placements(dims, mesh)

    return _tree_map(placements, cache)


def _distribute(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    # distribute_tensor would move a tensor to the mesh's device type
    # (a card's state onto the host for a CPU mesh): refuse instead
    if t.device.type not in ("meta", mesh.device_type):
        raise ValueError(f"a {t.device.type} tensor on a "
                         f"{mesh.device_type} mesh; lay the state out on "
                         f"the mesh's device first")
    d = distribute_tensor(t.detach(), mesh, placements)
    if isinstance(t, nn.Parameter):
        return nn.Parameter(d, requires_grad=t.requires_grad)
    return d


def shard_state(state_or_model, mesh, policy: str = "tp"):
    """Lay a model's parameters, or a train state's parameters, moments
    and step, out over ``mesh`` by their placements (``distribute_tensor``
    of each): the layout of the reference's ``in_shardings``.

    A model has its parameters replaced in place and is returned; a state
    ``{"params", "opt": {"m", "v", "step"}}`` is returned as a new dict of
    the same layout (a step binds its parameters into the model)."""
    if isinstance(state_or_model, nn.Module):
        model = state_or_model
        for name, pl in param_placements(model, mesh, policy).items():
            owner, _, attr = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            mod._parameters[attr] = _distribute(mod._parameters[attr], mesh,
                                                pl)
        return model
    pls = state_placements(state_or_model, mesh, policy)
    params, opt = state_or_model["params"], state_or_model["opt"]
    return {
        "params": {k: _distribute(v, mesh, pls["params"][k])
                   for k, v in params.items()},
        "opt": {"m": {k: _distribute(v, mesh, pls["opt"]["m"][k])
                      for k, v in opt["m"].items()},
                "v": {k: _distribute(v, mesh, pls["opt"]["v"][k])
                      for k, v in opt["v"].items()},
                "step": _distribute(opt["step"], mesh, pls["opt"]["step"])},
    }
