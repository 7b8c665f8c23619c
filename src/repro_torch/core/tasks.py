"""``MMTask`` binds the paper's multimodal model to the federated runtime.

* Backbone 1 (cnn): trainable = ALL parameters; the fusion FC weight is the
  row-blocked leaf.
* Backbone 2 (transformer): frozen encoders, fusion W0 and patch/projection
  weights stay in ``static``; trainable = the LoRA adapters + the task
  head; the fusion LoRA ``a`` is the row-blocked leaf.

The runtime never touches model details: it sees ``loss(trainable,
batch)``, the ``GroupLayout`` and the evaluation helpers.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import mdlora
from repro_torch.core import metrics as M
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import multimodal as MM


def _split_b2(params: dict) -> tuple[dict, dict]:
    """Backbone-2 trainable/static split."""
    trainable = {"lora": params["lora"], "head": params["base"]["head"]}
    static = {k: v for k, v in params["base"].items() if k != "head"}
    return trainable, static


def _merge_b2(trainable: dict, static: dict) -> dict:
    return {"base": dict(static) | {"head": trainable["head"]},
            "lora": trainable["lora"]}


@dataclasses.dataclass
class MMTask:
    cfg: MM.MMConfig
    layout: mdlora.GroupLayout
    static: Any = None  # Backbone 2's frozen leaves; None for Backbone 1

    @classmethod
    def create(cls, cfg: MM.MMConfig, generator: torch.Generator | None = None,
               params: Any = None, device: torch.device | str | None = None
               ) -> tuple[MMTask, Any]:
        """-> (task, trainable). ``params`` carries the model's weights over
        (a nested dict of numpy arrays or tensors, e.g. the reference's
        ``task.params(trainable)``); otherwise they are drawn from
        ``generator``."""
        dev = resolve_device(device)
        params = (MM.init_mm_model(generator, cfg, dev) if params is None
                  else params_from_numpy(params, dev))
        if cfg.backbone == "cnn":  # B1 trains everything, no fusion LoRA
            trainable = {k: v for k, v in params.items() if k != "lora"}
            static = None
        else:
            trainable, static = _split_b2(params)
        task = cls(cfg, mdlora.mm_group_layout(cfg, trainable), static)
        task.layout.flops = task.group_compute_flops()  # per-example fwd FLOPs
        return task, trainable

    def params(self, trainable: Any) -> dict:
        """The whole model's parameters for a trainable tree."""
        return (trainable if self.static is None
                else _merge_b2(trainable, self.static))

    def loss(self, trainable: Any, batch: dict) -> torch.Tensor:
        logits = MM.mm_forward(self.params(trainable), self.cfg, batch["x"],
                               batch["modality_mask"])
        return L.cross_entropy_logits(logits, batch["y"])

    def eval_f1(self, trainable: Any, xs, ys, modality_mask=None) -> float:
        mask = (np.ones((1, self.cfg.M), np.float32)
                if modality_mask is None else modality_mask)
        return M.evaluate_mm(self.params(trainable), self.cfg, xs, ys, mask)

    def eval_per_modality(self, trainable: Any, xs, ys) -> dict[str, float]:
        return M.per_modality_f1(self.params(trainable), self.cfg, xs, ys)

    # -- cost model ------------------------------------------------------------

    def group_compute_flops(self) -> np.ndarray:
        """[G] per-example forward FLOPs attributable to each parameter
        group (conv groups get their spatial reuse, unlike raw param counts).
        This drives tau profiling (Eq. 7), the FLOP-proportional timing of
        Sec. VI-A3 and the forward-aware model of Sec. VII."""
        cfg, layout = self.cfg, self.layout
        fl = np.zeros(layout.G)
        for g, name in enumerate(layout.names):
            if name.startswith("A_"):
                m = next(m for m in cfg.modalities if m.name == name[2:])
                fl[g] = 2.0 * m.d_feat * (cfg.lora_rank if cfg.backbone ==
                                          "transformer" else cfg.d_fused)
            elif name == "B_shared":
                fl[g] = 2.0 * cfg.lora_rank * cfg.d_fused
            elif name.startswith("E_") and cfg.backbone == "cnn":
                label = name.split("_")[-1]
                mname = name[2: -(len(label) + 1)]
                m = next(mm for mm in cfg.modalities if mm.name == mname)
                c1, c2 = cfg.cnn_ch
                if label == "conv1":
                    fl[g] = (cfg.window / 2) * cfg.cnn_kernel * m.channels * c1 * 2
                elif label == "conv2":
                    fl[g] = (cfg.window / 4) * cfg.cnn_kernel * c1 * c2 * 2
                else:  # proj
                    fl[g] = 2.0 * c2 * m.d_feat
            elif name.startswith("E_"):  # transformer encoder LoRA layer
                ntok = cfg.window // cfg.patch
                fl[g] = ntok * (4 * cfg.enc_d**2 + 2 * cfg.enc_d * cfg.enc_ff
                                + 2 * ntok * cfg.enc_d) * 2
            elif name.startswith("H_"):
                fl[g] = 2.0 * (cfg.d_fused * cfg.head_hidden
                               if "w1" in name else
                               cfg.head_hidden * cfg.n_classes)
        return np.maximum(fl, 1.0)

    def forward_flops_per_example(self) -> float:
        """Fixed full-model forward cost (paid regardless of elastic masking
        -- zero-padded inputs still traverse every encoder)."""
        return float(self.group_compute_flops().sum())
