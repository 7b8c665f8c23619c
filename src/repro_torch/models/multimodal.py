"""The paper's multimodal sensing model (Section III-B), Backbone 1.

Per-modality 2-layer 1-D CNN encoders E_m -> features h_m in R^{d_m}; the
fusion layer takes the ordered concatenation h = [h_1; ...; h_M] in R^D, and
its weight ``fusion_w0`` [D, d_fused] is the modality-blocked leaf (Eq. 1):
rows of a modality's block are that modality's fusion group. A two-layer head
classifies the fused representation. Backbone 1 trains every parameter.

Missing modalities: inputs are zero-padded (Eq. 2) and the encoder output
h_m is zeroed, so the fusion rows of an absent modality receive exactly zero
gradient (the paper's Assumption 4 with eps_0 = 0).

The transformer backbone (Backbone 2) is not ported yet; ``MMConfig`` keeps
its fields so configs stay one to one with the reference.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ModalitySpec:
    name: str
    channels: int
    d_feat: int  # d_m


@dataclasses.dataclass(frozen=True)
class MMConfig:
    name: str
    modalities: tuple[ModalitySpec, ...]
    window: int = 256  # 5.12 s @ 50 Hz (paper VI-A1)
    n_classes: int = 12
    backbone: str = "cnn"  # cnn | transformer
    d_fused: int = 128
    head_hidden: int = 64
    # cnn encoder
    cnn_ch: tuple[int, int] = (32, 64)
    cnn_kernel: int = 5
    # transformer encoder (frozen)
    enc_layers: int = 2
    enc_d: int = 64
    enc_heads: int = 4
    enc_ff: int = 128
    patch: int = 16
    # LoRA
    lora_rank: int = 8
    lora_alpha: float = 16.0
    dtype: str = "float32"

    @property
    def M(self) -> int:
        return len(self.modalities)

    @property
    def D(self) -> int:
        return sum(m.d_feat for m in self.modalities)

    @property
    def block_dims(self) -> tuple[int, ...]:
        return tuple(m.d_feat for m in self.modalities)

    @property
    def total_channels(self) -> int:
        return sum(m.channels for m in self.modalities)


def _init_cnn_encoder(gen: torch.Generator | None, spec: ModalitySpec,
                      cfg: MMConfig, device) -> dict:
    c1, c2 = cfg.cnn_ch
    return {
        "conv1": L.init_conv1d(gen, spec.channels, c1, cfg.cnn_kernel, device),
        "conv2": L.init_conv1d(gen, c1, c2, cfg.cnn_kernel, device),
        "proj": L.dense_init(gen, c2, spec.d_feat, device),
    }


def _cnn_encoder(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C] -> [B, d_feat]."""
    h = F.relu(L.conv1d(p["conv1"], x, stride=2))
    h = F.relu(L.conv1d(p["conv2"], h, stride=2))
    return h.mean(dim=-2) @ p["proj"]  # global average pool over time


def init_mm_model(generator: torch.Generator | None, cfg: MMConfig,
                  device: torch.device | str = "cpu") -> dict:
    """Backbone-1 parameters (every leaf trainable)."""
    if cfg.backbone != "cnn":
        raise NotImplementedError(
            f"backbone {cfg.backbone!r} is not ported yet (cnn only)")
    encoders = {m.name: _init_cnn_encoder(generator, m, cfg, device)
                for m in cfg.modalities}
    return {"base": {
        "encoders": encoders,
        "fusion_w0": L.dense_init(generator, cfg.D, cfg.d_fused, device),
        "head": {"w1": L.dense_init(generator, cfg.d_fused, cfg.head_hidden,
                                    device),
                 "w2": L.dense_init(generator, cfg.head_hidden,
                                    cfg.n_classes, device)},
    }}


def mm_features(params: dict, cfg: MMConfig, x: torch.Tensor,
                modality_mask: torch.Tensor) -> torch.Tensor:
    """-> fused-input features h = [h_1; ...; h_M] with absent blocks zeroed.

    x: [B, T, total_channels]; modality_mask: [M] or [B, M]. h_m := E_m(x_m)
    * mask_m, so an absent modality's fusion rows get exactly zero gradient.
    """
    hs, off = [], 0
    for i, m in enumerate(cfg.modalities):
        h = _cnn_encoder(params["base"]["encoders"][m.name],
                         x[..., off: off + m.channels])
        off += m.channels
        hs.append(h * modality_mask[..., i: i + 1].to(h.dtype))
    return torch.cat(hs, dim=-1)  # [B, D]


def mm_forward(params: dict, cfg: MMConfig, x: torch.Tensor,
               modality_mask: torch.Tensor) -> torch.Tensor:
    """-> logits [B, n_classes]."""
    h = mm_features(params, cfg, x, modality_mask)
    z = F.relu(h @ params["base"]["fusion_w0"])
    z = F.relu(z @ params["base"]["head"]["w1"])
    return z @ params["base"]["head"]["w2"]


def mm_loss(params: dict, cfg: MMConfig, batch: dict) -> torch.Tensor:
    logits = mm_forward(params, cfg, batch["x"], batch["modality_mask"])
    return L.cross_entropy_logits(logits, batch["y"])
