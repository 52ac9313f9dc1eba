"""granite-moe-1b-a400m — IBM Granite 3.0 1B-A400M MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  24L d_model=1024 16H
(GQA kv=8) d_ff=512 per expert, vocab=49155, MoE 32 experts top-8.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155,
    n_experts=32, top_k=8,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=128, n_experts=4, top_k=2, param_dtype="float32",
)
