"""The paper's multimodal sensing model (Section III-B).

Per-modality encoders E_m -> features h_m in R^{d_m}; the fusion layer takes
the ordered concatenation h = [h_1; ...; h_M] in R^D, and its projection
carries the modality-aligned row blocks of Eq. 1. A two-layer head
classifies the fused representation. Two backbones, as in the paper
(Section VI-A3):

* ``cnn``         -- Backbone 1: 2-layer 1-D CNN encoders, every parameter
  trained; the fusion weight ``fusion_w0`` [D, d_fused] is the blocked leaf.
* ``transformer`` -- Backbone 2: frozen bidirectional patch-transformer
  encoders with LoRA (rho = 8) on Q, V and the FFN, and a LoRA on the
  fusion layer whose ``a`` [D, r] is split into modality row blocks. The
  fusion projection ``(h*m)@W0 + ((h*m)@a)@b*scale`` runs through the fused
  kernel (``kernels/mdlora``: CUDA on the card, the plain version on the
  CPU) as one differentiable call.

Encoder layers keep the reference's stacked ``[L, ...]`` leaves (a Python
loop over L replaces ``lax.scan``), so a reference tree carries over as it
is and the group layout sees one leaf per module.

Missing modalities: inputs are zero-padded (Eq. 2) and the encoder output
h_m is zeroed, so the fusion rows of an absent modality receive exactly zero
gradient (the paper's Assumption 4 with eps_0 = 0).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mdlora.autograd import fused_block_lora
from repro_torch.kernels.mdlora.ops import block_row_mask
from repro_torch.models import layers as L
from repro_torch.tree import tree_map


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


def _init_tx_encoder(gen: torch.Generator | None, spec: ModalitySpec,
                     cfg: MMConfig, device) -> dict:
    d, n_l = cfg.enc_d, cfg.enc_layers
    dims = L.AttnDims(d, cfg.enc_heads, cfg.enc_heads, d // cfg.enc_heads)
    return {
        "patch": L.dense_init(gen, cfg.patch * spec.channels, d, device),
        "layers": {
            "attn": L.init_attention(gen, dims, device, layers=n_l),
            "mlp": L.init_glu_mlp(gen, d, cfg.enc_ff, device, layers=n_l),
            "ln1": torch.zeros((n_l, d), device=device),  # (1 + w) weights
            "ln2": torch.zeros((n_l, d), device=device),
        },
        "proj": L.dense_init(gen, d, spec.d_feat, device),
    }


def _lora_pair(gen: torch.Generator | None, lead: tuple[int, ...], din: int,
               dout: int, r: int, device) -> dict:
    """a ~ N(0, 1/din) [*lead, din, r]; b = 0 [*lead, r, dout]."""
    return {"a": L.normal(gen, lead + (din, r), 1.0 / math.sqrt(din), device),
            "b": torch.zeros(lead + (r, dout), device=device)}


def _init_tx_lora(gen: torch.Generator | None, cfg: MMConfig,
                  device) -> dict:
    """LoRA on Q/V + FFN of each encoder layer (paper VI-A3), stacked."""
    d, r, lead = cfg.enc_d, cfg.lora_rank, (cfg.enc_layers,)
    return {name: _lora_pair(gen, lead, d, dout, r, device)
            for name, dout in (("wq", d), ("wv", d), ("wi", cfg.enc_ff))}


def _tx_encoder(p: dict, lp: dict | None, cfg: MMConfig,
                x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C] -> [B, d_feat]; bidirectional patch transformer."""
    B, T, C = x.shape
    P = cfg.patch
    n_tok = T // P
    H = cfg.enc_heads
    hd = cfg.enc_d // H
    scale = cfg.lora_alpha / cfg.lora_rank
    h = x[:, : n_tok * P].reshape(B, n_tok, P * C) @ p["patch"]
    for i in range(cfg.enc_layers):
        pl = tree_map(lambda t, i=i: t[i], p["layers"])
        lpl = None if lp is None else tree_map(lambda t, i=i: t[i],
                                               lp["layers"])

        def proj(hn, w, name, lpl=lpl):
            out = hn @ w
            if lpl is not None:
                out = out + ((hn @ lpl[name]["a"]) @ lpl[name]["b"]) * scale
            return out

        hn = L.rmsnorm(pl["ln1"], h)
        q = proj(hn, pl["attn"]["wq"], "wq").reshape(B, n_tok, H, hd)
        k = (hn @ pl["attn"]["wk"]).reshape(B, n_tok, H, hd)
        v = proj(hn, pl["attn"]["wv"], "wv").reshape(B, n_tok, H, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        h = h + o.reshape(B, n_tok, H * hd) @ pl["attn"]["wo"]
        hn = L.rmsnorm(pl["ln2"], h)
        up = proj(hn, pl["mlp"]["wi"], "wi")
        h = h + (F.silu(hn @ pl["mlp"]["wg"]) * up) @ pl["mlp"]["wo"]
    return h.mean(dim=1) @ p["proj"]


def init_mm_model(generator: torch.Generator | None, cfg: MMConfig,
                  device: torch.device | str = "cpu") -> dict:
    """Model parameters: ``{"base": ...}`` for Backbone 1 (every leaf
    trainable); Backbone 2 adds ``"lora"`` (fusion and encoder adapters)."""
    init_enc = (_init_cnn_encoder if cfg.backbone == "cnn"
                else _init_tx_encoder)
    encoders = {m.name: init_enc(generator, m, cfg, device)
                for m in cfg.modalities}
    params = {"base": {
        "encoders": encoders,
        "fusion_w0": L.dense_init(generator, cfg.D, cfg.d_fused, device),
        "head": {"w1": L.dense_init(generator, cfg.d_fused, cfg.head_hidden,
                                    device),
                 "w2": L.dense_init(generator, cfg.head_hidden,
                                    cfg.n_classes, device)},
    }}
    if cfg.backbone == "transformer":
        params["lora"] = {
            # a is [D, r] = A^T; modality blocks are row ranges of a
            "fusion": _lora_pair(generator, (), cfg.D, cfg.d_fused,
                                 cfg.lora_rank, device),
            "encoders": {m.name: {"layers": _init_tx_lora(generator, cfg,
                                                          device)}
                         for m in cfg.modalities}}
    return params


def split_modalities(cfg: MMConfig, x: torch.Tensor
                     ) -> dict[str, torch.Tensor]:
    """x: [B, T, total_channels] (ordered concat) -> per-modality slices."""
    out, off = {}, 0
    for m in cfg.modalities:
        out[m.name] = x[..., off: off + m.channels]
        off += m.channels
    return out


def mm_features(params: dict, cfg: MMConfig, x: torch.Tensor,
                modality_mask: torch.Tensor) -> torch.Tensor:
    """-> fused-input features h = [h_1; ...; h_M] with absent blocks zeroed.

    x: [B, T, total_channels]; modality_mask: [M] or [B, M]. h_m := E_m(x_m)
    * mask_m, so an absent modality's fusion rows get exactly zero gradient.
    """
    xs = split_modalities(cfg, x)
    lora_enc = params.get("lora", {}).get("encoders")
    hs = []
    for i, m in enumerate(cfg.modalities):
        xm = xs[m.name]
        if cfg.backbone == "cnn":
            h = _cnn_encoder(params["base"]["encoders"][m.name], xm)
        else:
            h = _tx_encoder(params["base"]["encoders"][m.name],
                            None if lora_enc is None else lora_enc[m.name],
                            cfg, xm)
        hs.append(h * modality_mask[..., i: i + 1].to(h.dtype))
    return torch.cat(hs, dim=-1)  # [B, D]


def _fusion_row_mask(cfg: MMConfig, modality_mask: torch.Tensor
                    ) -> torch.Tensor:
    """The fused kernel's [D] row mask from an [M] or [1, M] modality mask.
    A [B, M] mask with B > 1 gives all ones: ``mm_features`` has already
    zeroed each row's absent blocks, so the product is the same."""
    mm = modality_mask.float()
    if mm.dim() == 2 and mm.shape[0] != 1:
        return torch.ones(cfg.D, device=mm.device)
    return block_row_mask(cfg.block_dims, mm.reshape(-1))


def mm_forward(params: dict, cfg: MMConfig, x: torch.Tensor,
               modality_mask: torch.Tensor) -> torch.Tensor:
    """-> logits [B, n_classes]."""
    h = mm_features(params, cfg, x, modality_mask)
    lora = params.get("lora", {}).get("fusion")
    if lora is None:  # Backbone 1: the blocked FC weight itself
        fused = h @ params["base"]["fusion_w0"]
    else:  # Backbone 2: the fused block-LoRA projection
        fused = fused_block_lora(
            h, params["base"]["fusion_w0"], lora["a"], lora["b"],
            _fusion_row_mask(cfg, modality_mask),
            cfg.lora_alpha / cfg.lora_rank)
    z = F.relu(fused)
    z = F.relu(z @ params["base"]["head"]["w1"])
    return z @ params["base"]["head"]["w2"]


def mm_loss(params: dict, cfg: MMConfig, batch: dict) -> torch.Tensor:
    logits = mm_forward(params, cfg, batch["x"], batch["modality_mask"])
    return L.cross_entropy_logits(logits, batch["y"])
