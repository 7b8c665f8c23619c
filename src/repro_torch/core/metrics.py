"""Evaluation metrics (paper VI-A1): macro-F1, the per-modality F1
breakdown (Fig. 6: the model evaluated with only that modality present),
the rare-modality F1 (mean over the small-cohort modalities) and the
time to accuracy."""
from __future__ import annotations

import numpy as np
import torch


def confusion(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int) -> float:
    cm = confusion(y_true, y_pred, n_classes)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    f1 = 2 * tp / np.maximum(2 * tp + fp + fn, 1e-12)
    present = cm.sum(1) > 0
    return float(f1[present].mean()) if present.any() else 0.0


@torch.no_grad()
def evaluate_mm(params, cfg, xs: np.ndarray, ys: np.ndarray,
                modality_mask: np.ndarray, batch: int = 256) -> float:
    """Global-model macro-F1 under a given modality availability mask, on
    the device the parameters live on."""
    from repro_torch.models.multimodal import mm_forward

    device = params["base"]["fusion_w0"].device
    mask = torch.as_tensor(np.asarray(modality_mask, np.float32),
                           device=device)
    preds = []
    for i in range(0, len(ys), batch):
        x = torch.as_tensor(xs[i:i + batch], device=device)
        preds.append(mm_forward(params, cfg, x, mask).argmax(-1).cpu().numpy())
    return macro_f1(ys, np.concatenate(preds), cfg.n_classes)


def per_modality_f1(params, cfg, xs, ys, batch: int = 256) -> dict[str, float]:
    """Fig. 6: F1 with only modality m present (others zero-masked)."""
    out = {}
    for i, m in enumerate(cfg.modalities):
        mask = np.zeros((1, cfg.M), np.float32)
        mask[0, i] = 1.0
        out[m.name] = evaluate_mm(params, cfg, xs, ys, mask, batch)
    return out


def rare_modality_f1(per_mod: dict[str, float], rare: tuple[str, ...]) -> float:
    return float(np.mean([per_mod[m] for m in rare]))


def time_to_accuracy(f1_curve: list[float], times: list[float],
                     threshold: float) -> float | None:
    """Wall-clock (simulated) time at which F1 first reaches threshold."""
    for f, t in zip(f1_curve, np.cumsum(times)):
        if f >= threshold:
            return float(t)
    return None
