"""hymba-1.5b [arXiv:2411.13676]: 32L, d=1600, 25H (GQA kv=5, head 64)
in parallel with SSD heads (d_inner=3200, state 16), d_ff=5504,
vocab=32001. Sliding-window attention in every layer (the published model
keeps 3 global layers). The [attn_out ; ssm_out] fusion projection is the
paper's modality-blocked fusion layer on an LM: MDLoRA block 0 = the
attention heads, block 1 = the SSD heads."""
import sys

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504, vocab=32001,
    ssm_state=16, ssm_head_dim=64, d_inner=3200, conv_kernel=4,
    ssd_chunk=64, layer_pattern="local", sliding_window=1024,
    activation="silu", tie_embeddings=True, dtype="bfloat16",
    param_dtype="bfloat16", q_chunk=1024, remat="dots",
    lora_targets=("wq", "wv", "wo_fusion"),
)

SMOKE = ModelConfig(
    arch="hymba-1.5b-smoke", family="hybrid", n_layers=2, d_model=64,
    n_heads=5, n_kv_heads=1, head_dim=16, d_ff=128, vocab=97, ssm_state=8,
    ssm_head_dim=16, d_inner=64, conv_kernel=4, ssd_chunk=16,
    layer_pattern="local", sliding_window=16, dtype="float32",
    param_dtype="float32", remat="none", q_chunk=16,
)

register("hymba-1.5b", sys.modules[__name__])
