"""phi3-medium-14b [arXiv:2404.14219]: 40L, d=5120, 40H (GQA kv=10),
d_ff=17920, vocab=100352 — RoPE + SwiGLU + GQA decoder."""
import sys

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, head_dim=128, d_ff=17920, vocab=100352,
    activation="silu", rope_theta=10000.0, tie_embeddings=False,
    dtype="bfloat16", param_dtype="bfloat16", q_chunk=1024, remat="dots",
)

SMOKE = ModelConfig(
    arch="phi3-medium-14b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160, vocab=128,
    tie_embeddings=False, dtype="float32", param_dtype="float32",
    remat="none", q_chunk=32,
)

register("phi3-medium-14b", sys.modules[__name__])
