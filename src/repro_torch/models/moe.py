"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The reference's dispatch, step for step: each token's top-k expert
choices are sorted (stably) by expert id, a choice's slot is its rank in
its expert's run (a left-sided search for the run's start), and the
inverse permutation brings the slots back to choice order.  Expert
buffers are ``[B, E, C, d]`` with ``C = ceil(T*k*cf/E)``; a choice past
its expert's capacity goes to the sink slot ``E*C`` and is dropped, so
the same tokens are dropped as in the reference.

Router extras: softmax probs renormalized over the top-k, the
Switch-style load-balance aux loss and the router z-loss.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..launch.sharding import UNSHARDED, Shardings
from .config import ModelConfig
from .layers import Initializer, dense_init

__all__ = ["moe_params", "moe_block"]


def moe_params(init: Optional[Initializer], cfg: ModelConfig, dtype,
               device) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init(init, (d, E), torch.float32, device,
                             scale=0.02),
        "w_gate": dense_init(init, (E, d, ff), dtype, device),
        "w_up": dense_init(init, (E, d, ff), dtype, device),
        "w_down": dense_init(init, (E, ff, d), dtype, device),
    }


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    c = int(-(-T * k * cf // E))
    return max(c, 1)


def _top_k(probs: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index (as
    ``lax.top_k``): a stable descending sort keeps equal values in index
    order, which ``torch.topk`` does not promise."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(x: torch.Tensor, p, cfg: ModelConfig,
              sh: Shardings = UNSHARDED
              ) -> Tuple[torch.Tensor, dict]:
    """x: [B, T, d] -> (y: [B, T, d], aux losses dict)."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, k, E, cfg.capacity_factor)
    dev = x.device

    logits = x.float() @ p["router"]                         # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)                          # [B, T, k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ---- aux losses (fp32) --------------------------------------------------
    # the expert choices (B x T x k, small) replicated: every rank counts
    # the whole batch's assignments as plain tensors
    top_e_all = sh.whole(top_e)
    me = probs.mean(dim=(0, 1))                              # mean router prob
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, top_e_all.reshape(-1),
        torch.full((B * T * k,), 1.0 / (B * T * k), dtype=torch.float32,
                   device=dev))                              # assignment frac
    aux = {
        "load_balance": E * torch.sum(me * ce),
        "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
    }

    # slotting, dispatch and combine are per batch row: under ``sh`` they
    # run on each rank's rows (a row's tokens, choices and expert buffers
    # stay on the rank that holds the row, as in the reference; DTensor's
    # gathers would replicate the whole batch and zero-fill its global
    # expert buffers in the backward), and on the rank's own experts
    xpl = sh.placements(x.shape, "batch")
    cpl = sh.placements(top_e.shape, "batch")
    ipl = sh.placements((B, T * k), "batch")
    epl = sh.placements((B, E, C, d), "batch", "experts", None, None)
    eaxis = sh.axis_of(epl, 1)

    def experts_here():
        """(first, count) of the experts this rank's buffers hold."""
        if eaxis is None:
            return 0, E
        mesh, i = eaxis
        n = E // mesh.size(i)
        return mesh.get_local_rank(i) * n, n

    def route(x, top_e):
        """Sort-based slotting of a block of rows, and their tokens
        gathered into this rank's experts' buffers ``[b, E_here, C, d]``;
        with each choice's buffer position and whether it fits."""
        b = x.shape[0]
        e_flat = top_e.reshape(b, T * k)
        e_sorted, order = torch.sort(e_flat, dim=-1, stable=True)
        idx = torch.arange(T * k, device=dev)[None, :]
        # start of each expert's run: left-sided search of the sorted ids
        starts = torch.searchsorted(
            e_sorted, torch.arange(E, device=dev).expand(b, E).contiguous())
        slot_sorted = idx - torch.gather(starts, 1, e_sorted)
        # invert the sort: the slot of each original choice position
        inv = torch.empty_like(order).scatter_(
            1, order, idx.expand(b, T * k).contiguous())
        slot = torch.gather(slot_sorted, 1, inv)             # [b, Tk]
        valid = slot < C
        tok = (idx // k).expand(b, T * k)                    # token of choice

        # for each (b, e, c) slot, which token fills it; overflow -> sink
        flat_pos = torch.where(valid, e_flat * C + slot, E * C)
        token_for_slot = torch.zeros((b, E * C + 1), dtype=torch.int64,
                                     device=dev).scatter_(1, flat_pos, tok)
        occupied = torch.zeros((b, E * C + 1), dtype=torch.bool,
                               device=dev).scatter_(
            1, flat_pos, torch.ones_like(flat_pos, dtype=torch.bool))
        e0, n = experts_here()
        token_for_slot = token_for_slot[:, e0 * C:(e0 + n) * C]
        occupied = occupied[:, e0 * C:(e0 + n) * C].reshape(b, n, C)

        # dispatch: gather token activations into expert buffers
        xe = torch.gather(x, 1,
                          token_for_slot[..., None].expand(b, n * C, d))
        xe = xe.reshape(b, n, C, d)
        xe = torch.where(occupied[..., None], xe,
                         torch.zeros((), dtype=x.dtype, device=dev))
        return xe, torch.where(valid, e_flat * C + slot, 0), valid

    xe, gather_pos, valid = sh.local(route, [epl, ipl, ipl], (x, xpl),
                                     (top_e, cpl))

    # ---- expert FFN (SwiGLU) ------------------------------------------------
    def ffn(xe, w_gate, w_up, w_down):
        g = torch.einsum("becd,edf->becf", xe, w_gate)
        u = torch.einsum("becd,edf->becf", xe, w_up)
        h = F.silu(g.float()).to(x.dtype) * u
        return torch.einsum("becf,efd->becd", h, w_down)     # [B, E, C, d]

    # each (batch row, expert) is its own product: the FFN runs on the
    # local shards, the weights gathered but for the expert axis
    ws = (p["w_gate"], p["w_up"], p["w_down"])
    wpl = sh.placements(ws[0].shape, "experts", None, None)
    ye = sh.local(ffn, epl, (xe, epl), *((w_, wpl) for w_ in ws))

    def combine(ye, gather_pos, valid, top_p):
        """Each choice's expert output, weighted, summed over a token's
        choices, of the choices whose expert is here (the others add
        zero): ``[b, T, d]``, a partial sum over the experts' mesh dim."""
        b = ye.shape[0]
        e0, n = experts_here()
        here = gather_pos - e0 * C
        mine = valid & (here >= 0) & (here < n * C)
        ye_flat = ye.reshape(b, n * C, d)
        y_choice = torch.gather(
            ye_flat, 1,
            torch.where(mine, here, 0)[..., None].expand(b, T * k, d))
        p_flat = top_p.reshape(b, T * k)
        y_choice = y_choice * (p_flat * mine)[..., None].to(x.dtype)
        return y_choice.reshape(b, T, k, d).sum(dim=2)

    # ---- combine: gather expert outputs back to (token, choice) -------------
    y = sh.local(combine, sh.summed(xpl, eaxis), (ye, epl),
                 (gather_pos, ipl), (valid, ipl), (top_p, cpl))
    return y, aux
