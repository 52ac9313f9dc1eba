"""Architecture registry: --arch <id> resolution for every launcher."""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ModelConfig

ARCHS = {
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen1.5-110b": "qwen1_5_110b",
    "llama3-405b": "llama3_405b",
    "llama3.2-1b": "llama3_2_1b",
    "granite-3-2b": "granite_3_2b",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

# default gradient-accumulation microbatches per arch for train_4k, the
# reference's values (sized for its accelerator mesh; llama3.2-1b trains
# on one 80 GB card at batch 8 x 1024 with 1 and remat)
TRAIN_MICROBATCHES: Dict[str, int] = {
    "llama3-405b": 8,
    "qwen1.5-110b": 4,
    "llama4-maverick-400b-a17b": 4,
    "phi-3-vision-4.2b": 2,
}

# Adam moment + gradient-accumulation dtype overrides: bf16 moments halve
# optimizer memory for the 100B+ archs (update math stays fp32); the
# reference's values, for ``AdamWConfig(moment_dtype=...)`` and (as
# ``dtype_of(name)``) ``make_train_step(accum_dtype=...)``.
OPT_MOMENT_DTYPE: Dict[str, str] = {
    "llama3-405b": "bfloat16",
    "qwen1.5-110b": "bfloat16",
    "llama4-maverick-400b-a17b": "bfloat16",
}
GRAD_ACCUM_DTYPE: Dict[str, str] = {
    "llama3-405b": "bfloat16",
    "llama4-maverick-400b-a17b": "bfloat16",
}


def get(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f".{ARCHS[arch]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG
