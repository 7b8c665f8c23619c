"""llava-next-34b [hf:llava-hf/llava-v1.6-34b-hf backbone class]: 60L,
d=7168, 56H (GQA kv=8), d_ff=20480, vocab=64000 — VLM. The anyres-tiling
vision frontend is a stub: the caller supplies precomputed patch embeddings
[B, n_patches, d_model], which the backbone prepends to the token stream
(``launch/serve.py`` draws them from the seed)."""
import sys

from repro_torch.configs.base import (ModelConfig, ShapeConfig,
                                      lm_input_specs, meta, register)

N_PATCHES = 2880  # anyres 4+1 tiles x 576 patches

FULL = ModelConfig(
    arch="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
    activation="silu", rope_theta=5000000.0, tie_embeddings=False,
    n_patches=N_PATCHES, dtype="bfloat16", param_dtype="bfloat16",
    q_chunk=1024, remat="dots",
)

SMOKE = ModelConfig(
    arch="llava-next-34b-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=97,
    tie_embeddings=False, n_patches=16, dtype="float32",
    param_dtype="float32", remat="none", q_chunk=16,
)

def input_specs(shape: ShapeConfig, cfg: ModelConfig = FULL) -> dict:
    """Prefill and train sequences are [patch embeddings ; text tokens],
    shape.seq_len positions in all; decode runs on the text tail."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return lm_input_specs(cfg, shape)
    n_text = S - cfg.n_patches
    if n_text <= 0:
        raise ValueError(f"seq_len {S} leaves no text after "
                         f"{cfg.n_patches} patches")
    specs = {"tokens": meta((B, n_text)),
             "patches": meta((B, cfg.n_patches, cfg.d_model),
                             cfg.runtime_dtype())}
    if shape.kind == "train":
        specs["labels"] = meta((B, n_text))
    return specs


register("llava-next-34b", sys.modules[__name__])
