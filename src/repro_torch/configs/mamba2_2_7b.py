"""mamba2-2.7b — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]  64L d_model=2560, ssm_state=128,
expand=2 (d_inner=5120, 80 SSD heads at P=64), vocab=50280.
Runs long_500k: decode state is O(1) in context length.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    param_dtype="float32",
)
