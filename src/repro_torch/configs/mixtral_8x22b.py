"""mixtral-8x22b [arXiv:2401.04088 family]: 56L, d=6144, 48H (GQA kv=8),
expert d_ff=16384, vocab=32768, MoE 8 experts top-2, SWA. ~141B params.
``fsdp`` and ``quantize_serve`` are kept as field values only: nothing
reads them on one card, so this model serves in bf16."""
import sys

from repro_torch.configs.base import (ModelConfig, ShapeConfig,
                                      lm_input_specs, register)

FULL = ModelConfig(
    arch="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab=32768,
    n_experts=8, top_k=2, capacity_factor=1.25, activation="silu",
    layer_pattern="local", sliding_window=4096, tie_embeddings=False,
    fsdp=True, quantize_serve=True, dtype="bfloat16", param_dtype="bfloat16",
    q_chunk=1024, remat="dots",
)

SMOKE = ModelConfig(
    arch="mixtral-8x22b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab=101, n_experts=4,
    top_k=2, layer_pattern="local", sliding_window=16, tie_embeddings=False,
    dtype="float32", param_dtype="float32", remat="none", q_chunk=32,
)


def input_specs(shape: ShapeConfig, cfg: ModelConfig = FULL) -> dict:
    return lm_input_specs(cfg, shape)


register("mixtral-8x22b", sys.modules[__name__])
