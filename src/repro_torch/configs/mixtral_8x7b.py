"""mixtral-8x7b [arXiv:2401.04088]: 32L, d=4096, 32H (GQA kv=8), expert
d_ff=14336, vocab=32000, MoE 8 experts top-2, sliding-window attention."""
import sys

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch="mixtral-8x7b", family="moe", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000, n_experts=8,
    top_k=2, capacity_factor=1.25, activation="silu", layer_pattern="local",
    sliding_window=4096, tie_embeddings=False, dtype="bfloat16",
    param_dtype="bfloat16", q_chunk=1024, remat="dots",
)

SMOKE = ModelConfig(
    arch="mixtral-8x7b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab=101, n_experts=4,
    top_k=2, layer_pattern="local", sliding_window=16, tie_embeddings=False,
    dtype="float32", param_dtype="float32", remat="none", q_chunk=32,
)

register("mixtral-8x7b", sys.modules[__name__])
