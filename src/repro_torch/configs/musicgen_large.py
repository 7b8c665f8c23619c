"""musicgen-large [arXiv:2306.05284]: 48L, d=2048, 32H (MHA kv=32),
d_ff=8192, vocab=2048 per codebook — decoder-only over 4 parallel EnCodec
codebook streams (delay pattern). The EnCodec audio frontend is a stub: the
backbone takes codebook token ids [B, S, n_codebooks], sums the codebooks'
embedding streams and predicts [B, S, n_codebooks, vocab] logits."""
import sys

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, vocab=2048,
    n_codebooks=4, activation="gelu", tie_embeddings=False,
    dtype="bfloat16", param_dtype="bfloat16", q_chunk=1024, remat="dots",
)

SMOKE = ModelConfig(
    arch="musicgen-large-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=33, n_codebooks=4,
    activation="gelu", tie_embeddings=False, dtype="float32",
    param_dtype="float32", remat="none", q_chunk=32,
)

register("musicgen-large", sys.modules[__name__])
