"""Gradient compression: per-leaf top-k sparsification with error feedback.

For data parallelism over many nodes the gradient all-reduce dominates
the slow links; top-k + error feedback (Deep Gradient Compression, Lin et
al.) cuts wire bytes about ``ratio``-fold while the residual buffer keeps
the optimizer unbiased in the long run.

No collective here is sparse, so on-wire sparsity is *modeled*: the step
reduces the densified sparse tensor (numerically identical to a sparse
reduce) and reports the modeled compressed bytes.  The error-feedback
dynamics, the part that affects convergence, are exact.  Trees are flat
``{name: tensor}`` dicts, as in ``optimizer.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

__all__ = ["CompressionConfig", "compress_init", "compress_grads",
           "modeled_wire_bytes"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    ratio: float = 0.01          # keep top 1% of entries per leaf
    min_k: int = 32              # floor per leaf


def compress_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Error-feedback residual buffers, fp32 zeros beside each leaf."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """1 where ``|x|`` reaches the k-th largest ``|x|``, else 0: ties with
    the threshold are all kept, so more than k entries may survive."""
    flat = torch.abs(x.reshape(-1))
    k = min(max(k, 1), flat.shape[0])
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh).to(x.dtype)


def compress_grads(grads: Dict[str, torch.Tensor],
                   residual: Dict[str, torch.Tensor],
                   cfg: CompressionConfig
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor], Dict[str, Any]]:
    """(grads, residual) -> (compressed_grads, new_residual, stats).

    compressed = top-k(grads + residual); the residual keeps the
    remainder.  Dropped entries are exactly zero, so a dense reduce of
    ``compressed`` equals a sparse one."""
    comp, new_res, kept, total = {}, {}, [], []
    for name, g in grads.items():
        a = g.to(torch.float32) + residual[name]
        k = max(int(cfg.ratio * a.numel()), cfg.min_k)
        mask = _topk_mask(a, k)
        send = a * mask
        kept.append(torch.sum(mask))
        total.append(a.numel())
        comp[name] = send.to(g.dtype)
        new_res[name] = a - send
    stats = {"kept_entries": sum(kept), "total_entries": float(sum(total))}
    return comp, new_res, stats


def modeled_wire_bytes(stats: Dict[str, Any], value_bytes: int = 4,
                       index_bytes: int = 4) -> float:
    """Bytes a sparse collective would move: (value + index) per kept."""
    return float(stats["kept_entries"]) * (value_bytes + index_bytes)
