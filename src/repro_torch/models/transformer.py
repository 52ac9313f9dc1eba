"""Model assembly: embedding, the layer stack, enc-dec, modality frontends,
and the two serving modes (prefill / decode).

Layer stacking.  The reference groups layers by the config's block pattern
(RecurrentGemma uses ("rec", "rec", "attn")), stacks each pattern
position's parameters on a leading axis and drives them with one
``lax.scan``.  Here every layer is its own module in a ``ModuleList``, in
the reference's layer order, and the stack is a Python loop.
``params_from_reference`` splits the reference's stacked leaves layer by
layer.

Training.  ``forward(..., remat=True)`` recomputes each pattern group's
activations in the backward (``torch.utils.checkpoint``, the reference's
rematerialization with nothing saveable), and a ``dtype_anchor`` opens
every pattern group, as in the reference's ``pattern_block``; the
remainder layers have neither.  The weights are parameters that take no
gradient until ``models.steps.init_train_state`` makes them trainable.

Modality frontends are stubs: precomputed patch/frame embeddings at
d_model come in beside the tokens and a linear adapter maps them into the
residual stream.  For enc-dec (seamless) the encoder consumes the frames
and every decoder layer cross-attends to its output.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.tree import _device_for
from ..launch.sharding import UNSHARDED, Shardings
from . import attention as ATT
from . import moe as MOE
from . import rglru as RG
from . import ssm as SSM
from .config import ModelConfig
from .layers import (Initializer, dense_init, dtype_anchor, dtype_of,
                     gated_mlp, gated_mlp_init, rms_norm)

__all__ = ["Model", "params_from_reference"]

_KIND_HAS_FFN = {"attn": True, "moe": True, "rec": True, "ssm": False}


def _fixed(t: torch.Tensor) -> nn.Parameter:
    """A serving weight: a parameter that takes no gradient (until
    ``init_train_state`` makes it trainable)."""
    return nn.Parameter(t, requires_grad=False)


def _pdict(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _fixed(v) for k, v in tensors.items()})


class Block(nn.Module):
    """One layer: ``norm1`` and its mixer (``attn``, ``ssm`` or ``rec``),
    ``norm2`` and its FFN (``mlp`` or ``moe``) where the kind has one, and
    in an enc-dec decoder ``cross_norm`` / ``cross_attn``."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device,
                 init: Optional[Initializer], cross: bool = False):
        super().__init__()
        d = cfg.d_model
        self.kind = kind

        def zeros():
            return _fixed(torch.zeros((d,), dtype=dtype, device=device))

        self.norm1 = zeros()
        if kind == "attn":
            self.attn = _pdict(ATT.attention_params(init, cfg, dtype,
                                                    device))
            self.mlp = _pdict(gated_mlp_init(init, d, cfg.d_ff, dtype,
                                             device))
            self.norm2 = zeros()
        elif kind == "moe":
            self.attn = _pdict(ATT.attention_params(init, cfg, dtype,
                                                    device))
            self.moe = _pdict(MOE.moe_params(init, cfg, dtype, device))
            self.norm2 = zeros()
        elif kind == "ssm":
            self.ssm = _pdict(SSM.ssm_params(init, cfg, dtype, device))
        elif kind == "rec":
            self.rec = _pdict(RG.rglru_params(init, cfg, dtype, device))
            self.mlp = _pdict(gated_mlp_init(init, d, cfg.d_ff, dtype,
                                             device))
            self.norm2 = zeros()
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        self.has_cross = cross
        if cross:
            self.cross_norm = zeros()
            self.cross_attn = _pdict(ATT.attention_params(init, cfg, dtype,
                                                          device))


class Model(nn.Module):
    """Architecture-agnostic model built from a ModelConfig.

    The weights live on ``device``: the card unless ``device="cpu"`` is
    passed (without CUDA and no such request this raises).  They are drawn
    from ``seed`` or, with ``params``, taken from a state dict such as
    ``params_from_reference`` makes; on ``device="meta"`` they are laid
    out and not drawn (the dry run's model).
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        dev = _device_for(None, device)
        dtype = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.kinds = cfg.layer_kinds()
        # the reference's stack plan: layers in groups of the block pattern
        # (one layer when there is none), then the remainder layers
        self.pattern = tuple(cfg.block_pattern or (self.kinds[0],))
        self.n_full = len(self.kinds) // len(self.pattern)
        # given weights are assigned after the structure is laid out on
        # the meta device; otherwise every weight is drawn here (on the
        # meta device: laid out only)
        where = torch.device("meta") if params is not None else dev
        init = (None if params is not None or dev.type == "meta"
                else Initializer(seed, dev))
        d, V = cfg.d_model, cfg.vocab
        self.embed = _fixed(dense_init(init, (V, d), dtype, where,
                                       scale=0.02))
        self.unembed = _fixed(dense_init(init, (d, V), dtype, where))
        self.final_norm = _fixed(torch.zeros((d,), dtype=dtype,
                                             device=where))
        if cfg.frontend != "none":
            self.frontend_adapter = _fixed(dense_init(init, (d, d), dtype,
                                                      where))
        self.layers = nn.ModuleList(
            Block(cfg, kind, dtype, where, init, cross=cfg.is_encdec)
            for kind in self.kinds)
        if cfg.is_encdec:
            self.enc_layers = nn.ModuleList(
                Block(cfg, "attn", dtype, where, init)
                for _ in range(cfg.enc_layers))
            self.enc_norm = _fixed(torch.zeros((d,), dtype=dtype,
                                               device=where))
        if params is not None:
            want = self.state_dict()
            if set(want) != set(params):
                raise KeyError(
                    f"params do not fit {cfg.name}: missing "
                    f"{sorted(set(want) - set(params))}, unexpected "
                    f"{sorted(set(params) - set(want))}")
            self.load_state_dict(
                {k: params[k].to(device=dev, dtype=want[k].dtype)
                 for k in want}, strict=True, assign=True)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # --------------------------------------------------------------- helpers
    def _embed(self, tokens, sh: Shardings = UNSHARDED):
        # the gather [B, T, d] runs on each rank's token shard (DTensor's
        # own index_put backward fails on some torch versions) over its
        # vocab shard of the table, gathered over the FSDP axes: a token
        # outside the shard reads zeros, and the sum over the vocab's mesh
        # dim (a partial sum until the layout below reduces it) is its row
        # (Megatron's vocab-parallel embedding: no rank holds, nor in the
        # backward zero-fills, the whole [V, d] table)
        tpl = sh.placements(tokens.shape, "batch")
        epl = sh.placements(self.embed.shape, "vocab")
        axis = sh.axis_of(epl, 0)

        def lookup(table, tok):
            if axis is None:
                return table[tok]
            mesh, i = axis
            local = tok - mesh.get_local_rank(i) * table.shape[0]
            mine = (local >= 0) & (local < table.shape[0])
            rows = table[torch.where(mine, local, 0)]
            return torch.where(mine[..., None], rows,
                               torch.zeros((), dtype=rows.dtype,
                                           device=rows.device))

        x = sh.local(lookup, sh.summed(tpl, axis), (self.embed, epl),
                     (tokens, tpl))
        x = x * (self.cfg.d_model ** 0.5)              # in the param dtype
        return sh.act(x, "batch", "seq", "embed")

    def _frontend(self, frontend_embeds, sh: Shardings = UNSHARDED):
        x = frontend_embeds.to(self.embed.dtype) @ self.frontend_adapter
        return sh.act(x, "batch", "seq", "embed")

    def _logits(self, x, unembed=None):
        """Final norm, unembedding (``unembed`` in the parameter's place:
        the parameter laid out for the product) and vocab mask."""
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.rms_eps)
        logits = x @ (self.unembed if unembed is None else unembed)
        if cfg.vocab_real and cfg.vocab_real != cfg.vocab:
            mask = torch.arange(cfg.vocab, device=x.device) < cfg.vocab_real
            logits = torch.where(mask[None, None, :], logits, -1e9)
        return logits

    @staticmethod
    def _gathered(h, sh: Shardings):
        """A block's normed input (and its output, before the residual
        add) whole over the sequence under ``sh``: Megatron's sequence
        parallelism, the residual stream sequence-sharded between blocks
        and the matmuls on it gathered.  Some torch versions' DTensor
        cannot flatten a sharded sequence into a matmul's rows, in the
        forward or, through a block's output, in the backward."""
        return sh.act(h, "batch", "seq_unsharded", "embed")

    def _sharded_logits(self, x, sh: Shardings):
        """The logits, vocab-sharded under ``sh`` (the reference constrains
        them before the vocab mask; the mask is elementwise, so after it
        gives the same values).  When a gradient is taken (grad mode on
        and the unembedding trainable) the product takes the weight's vocab
        shard gathered over the FSDP axes, so it runs on each rank's rows
        where they lie.  Left to DTensor, that product moves the rows
        instead when a rank holds fewer bytes of them than of the weight,
        and its backward then gathers the whole batch's logits gradient
        (4.6 GiB twice in qwen1.5-110b's train_4k cell on the multi-pod
        mesh).  Without a gradient (prefill, decode, a trained model
        under ``no_grad``) DTensor chooses."""
        h = self._gathered(x, sh)
        w = sh.act(self.unembed, None, "vocab") \
            if torch.is_grad_enabled() and self.unembed.requires_grad \
            else self.unembed
        logits = self._logits(h) if w is self.unembed else \
            self._logits(h, w)
        return sh.act(logits, "batch", "seq_unsharded", "vocab")

    def _block(self, x, layer: Block, *, positions, causal: bool,
               memory=None, collect_cache: bool = False,
               sh: Shardings = UNSHARDED):
        """One block over a full sequence.

        Returns (x, new_state, aux) — aux is a (load_balance, router_z)
        pair of fp32 scalars, zeros for non-MoE blocks.
        """
        cfg = self.cfg
        kind = layer.kind
        h = self._gathered(rms_norm(x, layer.norm1, cfg.rms_eps), sh)
        new_state = None
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = (zero, zero)
        if kind in ("attn", "moe"):
            window = cfg.window if cfg.family == "hybrid" else 0
            y, (k, v) = ATT.attention(h, layer.attn, cfg,
                                      positions=positions, causal=causal,
                                      window=window, sh=sh)
            if collect_cache:
                new_state = self._make_attn_cache(k, v, window, sh)
        elif kind == "ssm":
            y, st = SSM.ssm_block(h, layer.ssm, cfg, sh=sh)
            new_state = st if collect_cache else None
        else:
            y, st = RG.rglru_block(h, layer.rec, cfg, sh=sh)
            new_state = st if collect_cache else None
        x = sh.act(x + self._gathered(y, sh), "batch", "seq", "embed")

        if memory is not None and layer.has_cross:
            hc = self._gathered(rms_norm(x, layer.cross_norm, cfg.rms_eps),
                                sh)
            yc, (ck, cv) = ATT.attention(hc, layer.cross_attn, cfg,
                                         positions=None, memory=memory,
                                         sh=sh)
            x = x + self._gathered(yc, sh)
            if collect_cache:
                new_state = (new_state, (ck, cv))

        if _KIND_HAS_FFN[kind]:
            h2 = self._gathered(rms_norm(x, layer.norm2, cfg.rms_eps), sh)
            if kind == "moe":
                y2, moe_aux = MOE.moe_block(h2, layer.moe, cfg, sh=sh)
                aux = (moe_aux["load_balance"], moe_aux["router_z"])
                # the combine's partial sum over the experts' mesh dim is
                # reduce-scattered into the residual's sequence shards:
                # half the bytes of reducing it whole, and its backward
                # gathers the cotangent as the whole one's would
                y2 = sh.act(y2, "batch", "seq", "embed")
            else:
                y2 = self._gathered(gated_mlp(h2, layer.mlp, sh=sh), sh)
            x = sh.act(x + y2, "batch", "seq", "embed")
        return x, new_state, aux

    @staticmethod
    def _make_attn_cache(k, v, window, sh: Shardings = UNSHARDED):
        """Trim/align prefill K,V into the decode cache layout: a window
        layer keeps its last ``window`` positions in ring order (under
        ``sh`` on each rank's shards: DTensor has no strategy for the
        ring's index_put on some torch versions)."""
        if not window:
            return (k, v)
        T = k.shape[1]
        take = min(T, window)

        def ring(k, v):
            pos = torch.arange(T - take, T, device=k.device) % window
            ck = k.new_zeros((k.shape[0], window) + tuple(k.shape[2:]))
            cv = v.new_zeros((v.shape[0], window) + tuple(v.shape[2:]))
            ck[:, pos] = k[:, T - take:]
            cv[:, pos] = v[:, T - take:]
            return (ck, cv)

        pl = sh.placements(k.shape, "batch", "seq_unsharded", "kv_heads",
                           None)
        return sh.local(ring, [pl, pl], (k, pl), (v, pl))

    # ----------------------------------------------------------- full passes
    def forward(self, tokens, *, frontend_embeds=None,
                sh: Shardings = UNSHARDED,
                collect_cache: bool = False, bidirectional: bool = False,
                remat: bool = False):
        """Full-sequence forward.

        Returns (logits, cache_or_None, aux) with aux = dict of summed MoE
        auxiliary losses (zeros for non-MoE families).  The cache is
        ``{"layers": [state per layer], "memory": encoder output or
        None}``.  An enc-dec decoder is causal whatever ``bidirectional``
        says (the reference's encoder resets its flag before the decoder
        runs); the encoder itself is always bidirectional.  ``remat``
        recomputes each pattern group (and each encoder layer) in the
        backward instead of keeping its activations.  ``sh`` (a
        ``launch.sharding.Shardings``) constrains the activations' layout
        where the reference does; with DTensor weights.
        """
        cfg = self.cfg
        memory = None
        if cfg.is_encdec:
            memory = self._encode(frontend_embeds, remat, sh)
            x = self._embed(tokens, sh)
            bidirectional = False
        elif cfg.frontend != "none" and frontend_embeds is not None:
            x = torch.cat([self._frontend(frontend_embeds, sh),
                           self._embed(tokens, sh)], dim=1)
        else:
            x = self._embed(tokens, sh)

        positions = torch.arange(x.shape[1], device=x.device)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)

        def pattern_block(x, layers):
            """One group: (x, its layers' states, its summed aux pair)."""
            x = dtype_anchor(x)          # keep the backward in bf16
            states, lb, rz = [], zero, zero
            for layer in layers:
                x, st, aux = self._block(x, layer, positions=positions,
                                         causal=not bidirectional,
                                         memory=memory,
                                         collect_cache=collect_cache, sh=sh)
                lb, rz = lb + aux[0], rz + aux[1]
                states.append(st)
            return x, states, lb, rz

        P = len(self.pattern)
        lb, rz = zero, zero
        states = []
        for g in range(self.n_full):
            group = self.layers[g * P:(g + 1) * P]
            if remat:
                out = checkpoint(pattern_block, x, group, use_reentrant=False)
            else:
                out = pattern_block(x, group)
            x, sts, g_lb, g_rz = out
            lb, rz = lb + g_lb, rz + g_rz
            states.extend(sts)
        for layer in self.layers[self.n_full * P:]:      # the remainder
            x, st, aux = self._block(x, layer, positions=positions,
                                     causal=not bidirectional,
                                     memory=memory,
                                     collect_cache=collect_cache, sh=sh)
            lb, rz = lb + aux[0], rz + aux[1]
            states.append(st)

        logits = self._sharded_logits(x, sh)
        cache = ({"layers": states, "memory": memory} if collect_cache
                 else None)
        return logits, cache, {"load_balance": lb, "router_z": rz}

    def _encode(self, frames, remat: bool = False,
                sh: Shardings = UNSHARDED):
        """Encoder stack over frontend frames (bidirectional attention);
        with ``remat`` each layer is recomputed in the backward."""
        x = (self._frontend(frames, sh) if hasattr(self, "frontend_adapter")
             else frames)
        positions = torch.arange(x.shape[1], device=x.device)

        def body(x, layer):
            return self._block(x, layer, positions=positions,
                               causal=False, sh=sh)[0]

        for layer in self.enc_layers:
            x = (checkpoint(body, x, layer, use_reentrant=False) if remat
                 else body(x, layer))
        return self._gathered(rms_norm(x, self.enc_norm, self.cfg.rms_eps),
                              sh)

    # ------------------------------------------------------------ decode path
    def decode_cache_specs(self, batch: int, cache_len: int,
                           enc_len: int = 0):
        """A decode cache on the meta device (the dry run's input): the
        layout prefill returns and ``pad_cache`` grows, ``{"layers":
        [state per layer], "memory"}``, with a ``cache_len`` attention
        cache (a hybrid's window layers keep a ``window`` ring), fp32
        SSM/RG-LRU states, and for enc-dec the cross K/V and the encoder
        memory over ``enc_len`` frames."""
        cfg = self.cfg
        dtype = dtype_of(cfg.param_dtype)
        D, KV = cfg.head_dim_, cfg.n_kv_heads

        def shp(s, dt=dtype):
            return torch.empty(s, dtype=dt, device="meta")

        def one(kind):
            if kind in ("attn", "moe"):
                W = cfg.window if (cfg.family == "hybrid" and cfg.window) \
                    else cache_len
                st = (shp((batch, W, KV, D)), shp((batch, W, KV, D)))
            elif kind == "ssm":
                ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
                st = (shp((batch, cfg.conv_width - 1, ch)),
                      shp((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), torch.float32))
            elif kind == "rec":
                st = (shp((batch, cfg.conv_width - 1, cfg.rnn_width_)),
                      shp((batch, cfg.rnn_width_), torch.float32))
            else:
                raise ValueError(kind)
            if cfg.is_encdec:
                st = (st, (shp((batch, enc_len, KV, D)),
                           shp((batch, enc_len, KV, D))))
            return st

        memory = (shp((batch, enc_len, cfg.d_model)) if cfg.is_encdec
                  else None)
        return {"layers": [one(kind) for kind in self.kinds],
                "memory": memory}

    def decode_step(self, cache, tokens, pos: int,
                    sh: Shardings = UNSHARDED):
        """One-token decode.  tokens: [B, 1]; pos: absolute position.

        Returns (logits [B, 1, V], new_cache).  The attention layers'
        K/V caches are written in place (the new position's slot) and
        carried into ``new_cache``; the recurrent layers' states are new
        tensors.
        """
        cfg = self.cfg
        x = self._embed(tokens, sh)
        memory = cache.get("memory")
        new_states = []
        for layer, state in zip(self.layers, cache["layers"]):
            kind = layer.kind
            h = rms_norm(x, layer.norm1, cfg.rms_eps)
            if cfg.is_encdec:
                state, cross_state = state
            if kind in ("attn", "moe"):
                W = cfg.window if cfg.family == "hybrid" else 0
                y, nk, nv = ATT.decode_attention(
                    h, layer.attn, cfg, cache_k=state[0], cache_v=state[1],
                    pos=pos, window=W, sh=sh)
                new_state = (nk, nv)
            elif kind == "ssm":
                y, new_state = SSM.ssm_decode_step(
                    h, layer.ssm, cfg, conv_state=state[0],
                    ssm_state=state[1], sh=sh)
            else:
                y, new_state = RG.rglru_decode_step(
                    h, layer.rec, cfg, conv_state=state[0],
                    rnn_state=state[1])
            x = x + y
            if cfg.is_encdec and layer.has_cross:
                hc = rms_norm(x, layer.cross_norm, cfg.rms_eps)
                yc, _, _ = ATT.decode_attention(
                    hc, layer.cross_attn, cfg, cache_k=cross_state[0],
                    cache_v=cross_state[1], pos=pos, memory=memory, sh=sh)
                x = x + yc
                new_state = (new_state, cross_state)
            if _KIND_HAS_FFN[kind]:
                h2 = rms_norm(x, layer.norm2, cfg.rms_eps)
                if kind == "moe":
                    y2, _ = MOE.moe_block(h2, layer.moe, cfg, sh=sh)
                else:
                    y2 = gated_mlp(h2, layer.mlp, sh=sh)
                x = x + y2
            new_states.append(new_state)
        logits = self._sharded_logits(x, sh)
        return logits, {"layers": new_states, "memory": memory}


# ---------------------------------------------------------------------------
# the reference's weights
# ---------------------------------------------------------------------------

def _tensor(a) -> torch.Tensor:
    """A numpy leaf as a tensor: float32 as it is, bfloat16 (dtype name
    ``"bfloat16"``) through its raw ``uint16`` bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    if a.dtype != np.float32:
        raise TypeError(f"unsupported weight dtype {a.dtype}")
    return torch.from_numpy(a.copy())


def _flat(tree, prefix: str, out: dict, index=None) -> None:
    """Name every leaf of a (nested dict) param tree ``prefix + key
    [.key ...]``, taking row ``index`` of stacked leaves."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}.", out, index)
        else:
            out[prefix + k] = _tensor(v if index is None else v[index])


def params_from_reference(tree, cfg: ModelConfig, *,
                          device=None) -> Dict[str, torch.Tensor]:
    """The reference's ``Model.init`` tree (numpy leaves) as this model's
    state dict on ``device`` (the card unless ``device="cpu"``).

    The reference stacks each pattern position's layers on a leading
    ``[n_full, ...]`` axis (layer ``j * len(pattern) + pi`` is row ``j`` of
    position ``pi``) and keeps the remainder layers in a list; both are
    split here into per-layer names.
    """
    dev = _device_for(None, device)
    kinds = cfg.layer_kinds()
    pattern = cfg.block_pattern or (kinds[0],)
    n_full = len(kinds) // len(pattern)
    out: Dict[str, torch.Tensor] = {}
    for name in ("embed", "unembed", "final_norm", "frontend_adapter",
                 "enc_norm"):
        if name in tree:
            out[name] = _tensor(tree[name])
    for j in range(n_full):
        for pi in range(len(pattern)):
            layer = j * len(pattern) + pi
            _flat(tree["blocks"][str(pi)], f"layers.{layer}.", out, j)
            if cfg.is_encdec:
                _flat(tree["cross"][str(pi)], f"layers.{layer}.cross_",
                      out, j)
    for li, bp in enumerate(tree["rem"]):
        layer = n_full * len(pattern) + li
        _flat(bp, f"layers.{layer}.", out)
        if cfg.is_encdec:
            _flat(tree["cross_rem"][li], f"layers.{layer}.cross_", out)
    if cfg.is_encdec:
        for i in range(cfg.enc_layers):
            _flat(tree["enc_blocks"], f"enc_layers.{i}.", out, i)
    return {k: v.to(dev) for k, v in out.items()}
