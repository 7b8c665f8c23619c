"""gemma2-27b [arXiv:2408.00118]: 46L, d=4608, 32H (GQA kv=16), d_ff=36864,
vocab=256000 — alternating local(4096)/global attention, logit softcaps,
post-norms, GeGLU, query_pre_attn_scalar."""
import sys

from repro_torch.configs.base import (ModelConfig, ShapeConfig,
                                      lm_input_specs, register)

FULL = ModelConfig(
    arch="gemma2-27b", family="dense", n_layers=46, d_model=4608, n_heads=32,
    n_kv_heads=16, head_dim=128, d_ff=36864, vocab=256000, activation="gelu",
    layer_pattern="alternating", sliding_window=4096, attn_softcap=50.0,
    final_softcap=30.0, post_norms=True, tie_embeddings=True,
    # gemma2-27b: query_pre_attn_scalar = d_model/n_heads = 144; logits are
    # scaled by 1/sqrt(144) instead of the default 1/sqrt(head_dim=128)
    query_scale=144.0 ** -0.5,
    dtype="bfloat16", param_dtype="bfloat16", q_chunk=1024, remat="dots",
)

SMOKE = ModelConfig(
    arch="gemma2-27b-smoke", family="dense", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=192, vocab=128,
    activation="gelu", layer_pattern="alternating", sliding_window=16,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    query_scale=1.0 / 4.0, dtype="float32", param_dtype="float32",
    remat="none", q_chunk=32,
)


def input_specs(shape: ShapeConfig, cfg: ModelConfig = FULL) -> dict:
    return lm_input_specs(cfg, shape)


register("gemma2-27b", sys.modules[__name__])
