"""Assigned input shapes and meta-device input builders for the dry run.

Four LM shapes (seq_len x global_batch):
    train_4k     4,096 x 256    -> the train step
    prefill_32k  32,768 x 32    -> the prefill step
    decode_32k   32,768 x 128   -> the serve step (1 token, 32k cache)
    long_500k    524,288 x 1    -> the serve step; sub-quadratic archs only

``input_specs`` returns (step_kind, inputs) where the inputs are tensors
on the meta device: the reference's shapes and dtypes, never allocated
(the counterpart of its ``ShapeDtypeStruct``s).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.transformer import Model

__all__ = ["SHAPES", "ShapeSpec", "input_specs", "applicable",
           "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k needs a sub-quadratic decode state (SSM/hybrid only)."""
    if shape_name == "long_500k":
        return cfg.subquadratic
    return True


def skip_reason(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    if applicable(cfg, shape_name):
        return None
    return (f"{cfg.name} is a pure full-attention architecture; long_500k "
            f"requires sub-quadratic decode state (SSM/hybrid only)")


def _tok(shape) -> torch.Tensor:
    # the reference's int32 tokens; int64 here, as every port entry point
    # takes them (an index tensor)
    return torch.empty(shape, dtype=torch.int64, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str,
                spec: Optional[ShapeSpec] = None
                ) -> Tuple[str, Dict[str, Any]]:
    """Dry-run inputs for (arch x shape), on the meta device.

    Returns (step_kind, kwargs):
      train:   {"batch": {...}}
      prefill: {"batch": {...}}
      decode:  {"cache": ..., "tokens": ..., "pos": ...}
    Parameters come separately (``Model(cfg, device="meta")``).  ``spec``
    replaces the named shape (a cell cut to one card).
    """
    ss = spec or SHAPES[shape_name]
    if not applicable(cfg, ss.name):
        raise ValueError(skip_reason(cfg, ss.name))
    B, T = ss.global_batch, ss.seq_len
    if ss.step in ("train", "prefill"):
        batch: Dict[str, Any] = {"tokens": _tok((B, T))}
        if ss.step == "train":
            batch["labels"] = _tok((B, T))
        if cfg.frontend != "none":
            batch["frontend"] = torch.empty(
                (B, cfg.frontend_tokens, cfg.d_model), dtype=torch.bfloat16,
                device="meta")
        return ss.step, {"batch": batch}
    # decode: single token against a T-length cache
    enc_len = cfg.frontend_tokens if cfg.is_encdec else 0
    cache = Model(cfg, device="meta").decode_cache_specs(B, T,
                                                         enc_len=enc_len)
    # the position of the new token: the cache's last slot
    return "decode", {"cache": cache, "tokens": _tok((B, 1)), "pos": T - 1}
