"""``MMTask`` binds the paper's multimodal model to the federated runtime.

Backbone 1 (cnn): trainable = ALL parameters; the fusion FC weight is the
row-blocked leaf. The runtime never touches model details: it sees
``loss(trainable, batch)``, the ``GroupLayout`` and ``eval_f1``. Backbone 2
(frozen transformer + LoRA) is not ported yet.
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


@dataclasses.dataclass
class MMTask:
    cfg: MM.MMConfig
    layout: mdlora.GroupLayout

    @classmethod
    def create(cls, cfg: MM.MMConfig, generator: torch.Generator | None = None,
               params: Any = None, device: torch.device | str | None = None
               ) -> tuple[MMTask, Any]:
        """-> (task, trainable). ``params`` carries weights over (a nested
        dict of numpy arrays or tensors, e.g. the reference's); otherwise
        they are drawn from ``generator``."""
        if cfg.backbone != "cnn":
            raise NotImplementedError(
                f"backbone {cfg.backbone!r} is not ported yet (cnn only)")
        dev = resolve_device(device)
        trainable = (MM.init_mm_model(generator, cfg, dev) if params is None
                     else params_from_numpy(params, dev))
        task = cls(cfg, mdlora.mm_group_layout(cfg, trainable))
        task.layout.flops = task.group_compute_flops()  # per-example fwd FLOPs
        return task, trainable

    def loss(self, trainable: Any, batch: dict) -> torch.Tensor:
        logits = MM.mm_forward(trainable, self.cfg, batch["x"],
                               batch["modality_mask"])
        return L.cross_entropy_logits(logits, batch["y"])

    def eval_f1(self, trainable: Any, xs, ys, modality_mask=None) -> float:
        mask = (np.ones((1, self.cfg.M), np.float32)
                if modality_mask is None else modality_mask)
        return M.evaluate_mm(trainable, self.cfg, xs, ys, mask)

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
                fl[g] = 2.0 * m.d_feat * cfg.d_fused
            elif name == "B_shared":
                fl[g] = 2.0 * cfg.lora_rank * cfg.d_fused
            elif name.startswith("E_"):
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
            elif name.startswith("H_"):
                fl[g] = 2.0 * (cfg.d_fused * cfg.head_hidden
                               if "w1" in name else
                               cfg.head_hidden * cfg.n_classes)
        return np.maximum(fl, 1.0)

    def forward_flops_per_example(self) -> float:
        """Fixed full-model forward cost (paid regardless of elastic masking
        -- zero-padded inputs still traverse every encoder)."""
        return float(self.group_compute_flops().sum())
