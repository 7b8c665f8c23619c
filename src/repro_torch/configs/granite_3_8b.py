"""granite-3-8b [hf:ibm-granite/granite-3.0-*-base family]: 40L, d=4096,
32H (GQA kv=8), d_ff=12800, vocab=49155 — GQA + SwiGLU."""
import sys

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch="granite-3-8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=12800, vocab=49155,
    activation="silu", tie_embeddings=True, dtype="bfloat16",
    param_dtype="bfloat16", q_chunk=1024, remat="dots",
)

SMOKE = ModelConfig(
    arch="granite-3-8b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=100, vocab=99,
    dtype="float32", param_dtype="float32", remat="none", q_chunk=32,
)

register("granite-3-8b", sys.modules[__name__])
