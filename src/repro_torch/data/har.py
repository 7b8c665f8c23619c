"""Synthetic PAMAP2 / MHEALTH lookalike datasets (offline container — see
DESIGN.md §9 for the deviation note).

Faithful surface statistics: 4 sensor modalities at 50 Hz, 5.12 s windows of
256 samples (paper VI-A1), 12 activity classes, subject-partitioned non-IID
clients (8 for PAMAP2, 10 for MHEALTH). Signals are class-conditional
harmonic mixtures with modality-specific character (IMU: movement-band
harmonics; HR: slow drift around a class-dependent level; ECG: periodic
spikes) plus *subject* effects (gain/phase/noise/class-prior skew) so client
distributions are genuinely non-IID.
"""
from __future__ import annotations

import dataclasses

import numpy as np

WINDOW = 256
RATE_HZ = 50.0


@dataclasses.dataclass(frozen=True)
class ModalityDef:
    name: str
    channels: int
    kind: str  # imu | pulse | ecg


DATASETS = {
    "pamap2": {
        "modalities": (ModalityDef("acc", 3, "imu"), ModalityDef("gyro", 3, "imu"),
                       ModalityDef("mag", 3, "imu"), ModalityDef("hr", 1, "pulse")),
        "n_subjects": 8, "n_classes": 12,
    },
    "mhealth": {
        "modalities": (ModalityDef("acc", 3, "imu"), ModalityDef("gyro", 3, "imu"),
                       ModalityDef("mag", 3, "imu"), ModalityDef("ecg", 2, "ecg")),
        "n_subjects": 10, "n_classes": 12,
    },
}


@dataclasses.dataclass
class HARDataset:
    name: str
    train_x: list[np.ndarray]  # per-subject [n, WINDOW, C]
    train_y: list[np.ndarray]
    test_x: list[np.ndarray]
    test_y: list[np.ndarray]
    n_classes: int
    modalities: tuple[ModalityDef, ...]

    @property
    def n_subjects(self) -> int:
        return len(self.train_x)

    def channels(self) -> int:
        return sum(m.channels for m in self.modalities)


def _modality_signal(kind: str, cls: int, n_ch: int, n: int, t: np.ndarray,
                     rng: np.random.Generator, gain: float, phase: float,
                     noise: float) -> np.ndarray:
    """-> [n, WINDOW, n_ch] class-conditional signals."""
    out = np.zeros((n, WINDOW, n_ch), np.float32)
    base_f = 0.6 + 0.37 * cls  # class-dependent fundamental (Hz)
    for ch in range(n_ch):
        ph = rng.uniform(0, 2 * np.pi, size=(n, 1)) + phase + 0.9 * ch
        if kind == "imu":
            f1 = base_f * (1.0 + 0.11 * ch)
            sig = (np.sin(2 * np.pi * f1 * t[None] + ph)
                   + 0.5 * np.sin(2 * np.pi * 2 * f1 * t[None] + 1.7 * ph)
                   + 0.25 * np.sin(2 * np.pi * 3.1 * f1 * t[None]))
            amp = 1.0 + 0.3 * cls
        elif kind == "pulse":  # heart rate: class-dependent level + slow drift
            level = (55.0 + 7.0 * cls) / 100.0
            sig = level + 0.08 * np.sin(2 * np.pi * 0.08 * (1 + 0.2 * cls)
                                        * t[None] + ph)
            amp = 1.0
        else:  # ecg: periodic spike train, rate grows with class
            rate = 1.0 + 0.15 * cls  # beats/s
            carrier = np.sin(2 * np.pi * rate * t[None] + ph)
            sig = np.exp(-30.0 * (1 - carrier)) + 0.1 * np.sin(
                2 * np.pi * 0.3 * t[None] + ph)
            amp = 1.0
        out[..., ch] = gain * amp * sig
    out += rng.normal(0, noise, size=out.shape).astype(np.float32)
    return out


def synthesize_dataset(name: str, modalities: tuple[ModalityDef, ...],
                       n_classes: int, n_subjects: int,
                       windows_per_subject: int = 240,
                       test_frac: float = 0.25, seed: int = 0,
                       alpha: float = 1.0) -> HARDataset:
    """Spec-driven synthesis: any (modalities, n_classes, n_subjects) tuple
    gets the same class-conditional + subject-effect generative process, so
    dataset providers beyond the two HAR presets (data/registry.py) plug in
    without touching this module. ``alpha``: Dirichlet concentration of
    per-subject class priors (non-IID)."""
    mods = modalities
    n_subj = n_subjects
    rng = np.random.default_rng(seed)
    t = np.arange(WINDOW, dtype=np.float32) / RATE_HZ

    tr_x, tr_y, te_x, te_y = [], [], [], []
    for s in range(n_subj):
        prior = rng.dirichlet(alpha * np.ones(n_classes))
        gain = float(np.exp(rng.normal(0, 0.1)))
        phase = float(rng.uniform(0, 2 * np.pi))
        noise = float(rng.uniform(0.12, 0.3))
        counts = rng.multinomial(windows_per_subject, prior)
        xs, ys = [], []
        for cls, cnt in enumerate(counts):
            if cnt == 0:
                continue
            parts = [_modality_signal(m.kind, cls, m.channels, cnt, t, rng,
                                      gain, phase, noise) for m in mods]
            xs.append(np.concatenate(parts, axis=-1))
            ys.append(np.full(cnt, cls, np.int32))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        perm = rng.permutation(len(y))
        x, y = x[perm], y[perm]
        n_te = max(1, int(test_frac * len(y)))
        te_x.append(x[:n_te])
        te_y.append(y[:n_te])
        tr_x.append(x[n_te:])
        tr_y.append(y[n_te:])
    return HARDataset(name, tr_x, tr_y, te_x, te_y, n_classes, mods)


def make_har_dataset(name: str, windows_per_subject: int = 240,
                     test_frac: float = 0.25, seed: int = 0,
                     n_subjects: int | None = None,
                     alpha: float = 1.0) -> HARDataset:
    """The two paper presets (PAMAP2 / MHEALTH lookalikes), registered as
    dataset providers in data/registry.py."""
    spec = DATASETS[name]
    return synthesize_dataset(name, spec["modalities"], spec["n_classes"],
                              n_subjects or spec["n_subjects"],
                              windows_per_subject=windows_per_subject,
                              test_frac=test_frac, seed=seed, alpha=alpha)


def mm_config_for(name: str, backbone: str = "cnn", d_feat: int = 32,
                  **overrides):
    """Build the paper's MMConfig for a dataset."""
    from repro_torch.models.multimodal import MMConfig, ModalitySpec

    spec = DATASETS[name]
    mods = tuple(ModalitySpec(m.name, m.channels,
                              d_feat if m.kind == "imu" else d_feat // 2)
                 for m in spec["modalities"])
    return MMConfig(name=name, modalities=mods, n_classes=spec["n_classes"],
                    backbone=backbone, **overrides)


def client_batches(x: np.ndarray, y: np.ndarray, batch: int, steps: int,
                   rng: np.random.Generator) -> dict:
    """Sample [steps, batch] with replacement -> stacked jnp-ready arrays."""
    idx = rng.integers(0, len(y), size=(steps, batch))
    return {"x": x[idx], "y": y[idx]}
