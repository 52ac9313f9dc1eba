"""llama3-405b — the dense-scaling flagship.

[arXiv:2407.21783; unverified]  126L d_model=16384 128H (GQA kv=8)
d_ff=53248 vocab=128256.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, head_dim=128, rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=192, vocab=128, param_dtype="float32",
)
