"""granite-34b [arXiv:2405.04324]: 88L, d=6144, 48H (MQA kv=1), d_ff=24576,
vocab=49152 — llama-style code model with multi-query attention. The GLU
MLP has three matrices where the published model has two, so FULL counts
46.9 B parameters, not 34 B."""
import sys

from repro_torch.configs.base import (ModelConfig, ShapeConfig,
                                      lm_input_specs, register)

FULL = ModelConfig(
    arch="granite-34b", family="dense", n_layers=88, d_model=6144, n_heads=48,
    n_kv_heads=1, head_dim=128, d_ff=24576, vocab=49152, activation="gelu",
    tie_embeddings=True, dtype="bfloat16", param_dtype="bfloat16",
    q_chunk=1024, remat="dots",
)

SMOKE = ModelConfig(
    arch="granite-34b-smoke", family="dense", n_layers=3, d_model=64,
    n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab=96,
    activation="gelu", dtype="float32", param_dtype="float32", remat="none",
    q_chunk=32,
)


def input_specs(shape: ShapeConfig, cfg: ModelConfig = FULL) -> dict:
    return lm_input_specs(cfg, shape)


register("granite-34b", sys.modules[__name__])
