"""llama4-maverick-400b-a17b — Llama-4 MoE (early fusion noted; text towers).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120 40H
(GQA kv=8) d_ff=8192 per expert, vocab=202048, MoE 128 experts top-1.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    n_experts=128, top_k=1, head_dim=128,
)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=128, n_experts=8, top_k=1, param_dtype="float32",
)
