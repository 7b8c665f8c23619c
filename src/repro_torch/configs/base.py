"""Config dataclass + the registry of the architectures.

``ModelConfig`` keeps every field of ``repro/configs/base.py`` with the same
defaults, so a reference config converts field by field; ``runtime_dtype``
and ``p_dtype`` return torch dtypes. Each architecture file exports

  FULL   the published configuration (served at full width on one H100; a
         model whose bf16 weights exceed the card runs there cut in depth)
  SMOKE  a reduced same-family configuration (CPU tests)

  input_specs(shape, cfg=FULL)  stand-ins for every input of a step at
         one of the four shapes, as tensors on ``meta`` (no memory)

All ten of the reference's LM architectures register. ``ShapeConfig`` and
the four input regimes are the dry-run's (``launch/dryrun.py``);
``long_500k`` cells of a pure full-attention architecture are unsupported
(``supports``).
"""
from __future__ import annotations

import dataclasses
import importlib
from types import ModuleType

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | multimodal
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0
    activation: str = "silu"
    rope_theta: float = 10000.0
    sliding_window: int | None = None
    layer_pattern: str = "global"  # global | local | alternating(local,global)
    attn_softcap: float | None = None
    final_softcap: float | None = None
    query_scale: float | None = None
    post_norms: bool = False
    tie_embeddings: bool = True
    norm: str = "rmsnorm"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "sparse"
    # SSM (mamba-2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_inner: int = 0
    conv_kernel: int = 4
    ssd_chunk: int = 256
    # audio (musicgen): parallel codebook streams
    n_codebooks: int = 0
    # vlm (llava): number of image patch embeddings prepended
    n_patches: int = 0
    # LoRA (RELIEF operates on these)
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_targets: tuple[str, ...] = ("wq", "wv", "wo_fusion")
    # numerics / execution
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    lora_dtype: str = "float32"
    q_chunk: int = 1024
    # "pallas" = the op in repro_torch.kernels (CUDA kernel on a card tensor,
    # ref.py on a CPU tensor); "xla" = the plain chunked attention
    attn_impl: str = "xla"
    # scan_layers, seq_shard, fsdp and quantize_serve are read by the
    # reference's compiler and mesh paths only; kept so that configs convert
    # field by field
    scan_layers: bool = True
    # per-layer activation checkpointing under a backward: none | dots
    # (keep the projections' outputs) | full (keep nothing)
    remat: str = "dots"
    seq_shard: bool = False
    # CE loss computed in S-chunks (bounds the [B, S, V] logits transient
    # of a 100k+ vocab); 1 = off
    loss_chunks: int = 1
    fsdp: bool = False
    quantize_serve: bool = False
    kv_quant: bool = False  # int8 KV cache with per-token scales (serving)

    @property
    def heads_per_group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def runtime_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def p_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.param_dtype == "bfloat16"
                else torch.float32)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}

_REGISTRY: dict[str, ModuleType] = {}
_PORTED = ("phi3_medium_14b", "gemma2_27b", "granite_34b", "granite_3_8b",
           "llava_next_34b", "musicgen_large", "mixtral_8x7b",
           "mixtral_8x22b", "mamba2_1_3b", "hymba_1_5b")


def register(arch_id: str, module: ModuleType) -> None:
    _REGISTRY[arch_id] = module


def _load_all() -> None:
    for name in _PORTED:
        importlib.import_module(f"repro_torch.configs.{name}")


def get_arch(arch_id: str) -> ModuleType:
    if not _REGISTRY:
        _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"{arch_id!r} is not ported; ported: {list_archs()}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# shared input_specs helpers
# ---------------------------------------------------------------------------


def meta(shape: tuple[int, ...], dtype: torch.dtype = torch.int32
         ) -> torch.Tensor:
    """A shape-and-dtype stand-in: an empty tensor on ``meta``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def lm_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for an LM step's inputs (``meta`` tensors): train ->
    tokens, labels [B, S]; prefill -> tokens [B, S]; decode -> one new
    token [B, 1] and a scalar position against a cache of S tokens."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": meta((B, S)), "labels": meta((B, S))}
    if shape.kind == "prefill":
        return {"tokens": meta((B, S))}
    return {"token": meta((B, 1)), "pos": meta(())}


def supports(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k requires sub-quadratic attention (bounded KV or SSM
    state): an ssm or hybrid family, or a sliding window."""
    if shape.name != "long_500k":
        return True
    if cfg.family in ("ssm", "hybrid"):
        return True
    return cfg.sliding_window is not None
