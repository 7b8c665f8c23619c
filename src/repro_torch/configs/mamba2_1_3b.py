"""mamba2-1.3b [arXiv:2405.21060]: 48L, d=2048, attention-free SSD,
ssm_state=128, d_inner=4096, head_dim=64 (64 SSD heads), vocab=50280.
MDLoRA's modality semantics do not apply (attention-free, single stream);
the LoRA adapters sit on the mixer's in/out projections."""
import sys

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048, vocab=50280,
    ssm_state=128, ssm_head_dim=64, d_inner=4096, conv_kernel=4,
    ssd_chunk=64, tie_embeddings=True, dtype="bfloat16",
    param_dtype="bfloat16", remat="dots",
)

SMOKE = ModelConfig(
    arch="mamba2-1.3b-smoke", family="ssm", n_layers=2, d_model=64, vocab=96,
    ssm_state=16, ssm_head_dim=16, d_inner=128, conv_kernel=4, ssd_chunk=16,
    dtype="float32", param_dtype="float32", remat="none",
)

register("mamba2-1.3b", sys.modules[__name__])
