"""qwen1.5-110b — dense GQA with QKV bias.

[hf:Qwen/Qwen1.5-0.5B (family); hf]  80L d_model=8192 64H (GQA kv=8)
d_ff=49152 vocab=152064, QKV bias on.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab=152064, qkv_bias=True, head_dim=128,
)

SMOKE = ModelConfig(
    name="qwen-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=192, vocab=128, qkv_bias=True, param_dtype="float32",
)
