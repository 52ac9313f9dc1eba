"""recurrentgemma-2b — RG-LRU + local attention hybrid (Griffin).

[arXiv:2402.19427; hf]  26L d_model=2560 10H (MQA kv=1, head_dim 256)
d_ff=7680 vocab=256000; block pattern (rec, rec, attn) — 1 local-attn per
2 RG-LRU layers, window 2048.  Runs long_500k: recurrent state + bounded
window cache.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    window=2048, rnn_width=2560, block_pattern=("rec", "rec", "attn"),
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=128, window=8, rnn_width=64,
    block_pattern=("rec", "rec", "attn"), param_dtype="float32",
)
