"""seamless-m4t-medium — encoder-decoder multimodal (audio frontend stub).

[arXiv:2308.11596; hf]  12L (x2: encoder+decoder) d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206.  The speech frontend is a STUB: input_specs
provides 1024 precomputed frame embeddings consumed by the encoder; the
decoder cross-attends.  Decode shapes exercise the decoder.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206,
    frontend="audio", frontend_tokens=1024,
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128,
    frontend="audio", frontend_tokens=8, param_dtype="float32",
)
