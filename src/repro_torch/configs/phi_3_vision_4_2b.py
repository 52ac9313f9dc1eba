"""phi-3-vision-4.2b — phi3-mini backbone + CLIP vision frontend (stub).

[hf:microsoft/Phi-3-vision-128k-instruct; hf]  32L d_model=3072 32H
(kv=32 => MHA) d_ff=8192 vocab=32064.  Vision frontend is a STUB per the
assignment: input_specs supplies 576 precomputed CLIP-ViT-L/14-336 patch
embeddings at d_model.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
    frontend="vision", frontend_tokens=576,
)

SMOKE = ModelConfig(
    name="phi-3-vision-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128,
    frontend="vision", frontend_tokens=8, param_dtype="float32",
)
