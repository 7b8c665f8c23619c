"""Dataset provider registry — the pluggable data side of the scenario matrix.

Every experiment used to hardcode ``make_har_dataset`` + ``mm_config_for``;
this module extracts the implicit contract into a ``DatasetProvider``
protocol (modalities, splits, client batch sampling, model config) and a
name-keyed registry, so PAMAP2/MHEALTH-shaped loaders and the UCF101-style
A+V scenario plug into the engines without touching engine code:

    provider = get_provider("ucf101_av")
    ds = provider.build(seed=0, n_clients=16)
    cfg = provider.mm_config(backbone="cnn", small=True)

``make_har_dataset`` remains the implementation of the two HAR presets; here
they are simply registered providers alongside the synthetic audio+video
scenario (fed-multimodal's UCF101 A+V surface: two modalities with a wide
channel-count gap, 10 action classes).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import har
from repro_torch.data.har import HARDataset, ModalityDef

try:  # Protocol is typing-only; keep import local failures impossible
    from typing import Protocol, runtime_checkable
except ImportError:  # pragma: no cover
    Protocol = object  # type: ignore

    def runtime_checkable(x):  # type: ignore
        return x


# model-size presets shared by benchmarks/ and sim/scenarios.py (previously
# copy-pasted into every bench _build block)
SIZE_PRESETS = {
    ("cnn", True): dict(d_feat=16, d_fused=64, cnn_ch=(16, 32)),
    ("cnn", False): dict(d_feat=32, d_fused=128, cnn_ch=(32, 64)),
    ("transformer", True): dict(d_feat=16, d_fused=64, enc_layers=2,
                                enc_d=32, enc_ff=64),
    ("transformer", False): dict(d_feat=32, d_fused=128, enc_layers=4,
                                 enc_d=128, enc_ff=256),
}


@runtime_checkable
class DatasetProvider(Protocol):
    """What the engines need from a dataset source.

    ``build`` returns a split container with per-client ``train_x/train_y/
    test_x/test_y`` lists plus ``n_classes``/``modalities`` (the HARDataset
    surface); ``mm_config`` returns the matching model config;
    ``client_batches`` samples stacked local-training batches.
    """
    name: str

    def modalities(self) -> tuple[ModalityDef, ...]: ...

    def n_classes(self) -> int: ...

    def build(self, *, windows_per_subject: int = 240,
              test_frac: float = 0.25, seed: int = 0,
              n_clients: int | None = None,
              alpha: float = 1.0) -> HARDataset: ...

    def mm_config(self, backbone: str = "cnn", small: bool = True,
                  **overrides): ...

    def client_batches(self, x: np.ndarray, y: np.ndarray, batch: int,
                       steps: int, rng: np.random.Generator) -> dict: ...


@dataclasses.dataclass(frozen=True)
class SyntheticProvider:
    """Spec-driven synthetic provider (har.synthesize_dataset under any
    modality/class/subject tuple)."""
    name: str
    mods: tuple[ModalityDef, ...]
    classes: int
    default_subjects: int

    def modalities(self) -> tuple[ModalityDef, ...]:
        return self.mods

    def n_classes(self) -> int:
        return self.classes

    def build(self, *, windows_per_subject: int = 240,
              test_frac: float = 0.25, seed: int = 0,
              n_clients: int | None = None,
              alpha: float = 1.0) -> HARDataset:
        return har.synthesize_dataset(
            self.name, self.mods, self.classes,
            n_clients or self.default_subjects,
            windows_per_subject=windows_per_subject, test_frac=test_frac,
            seed=seed, alpha=alpha)

    def mm_config(self, backbone: str = "cnn", small: bool = True,
                  **overrides):
        from repro_torch.models.multimodal import MMConfig, ModalitySpec

        kw = dict(SIZE_PRESETS[(backbone, small)]) | overrides
        d_feat = kw.pop("d_feat")
        mods = tuple(ModalitySpec(m.name, m.channels,
                                  d_feat if m.kind == "imu" else d_feat // 2)
                     for m in self.mods)
        return MMConfig(name=self.name, modalities=mods,
                        n_classes=self.classes, backbone=backbone, **kw)

    def client_batches(self, x: np.ndarray, y: np.ndarray, batch: int,
                       steps: int, rng: np.random.Generator) -> dict:
        return har.client_batches(x, y, batch, steps, rng)


_PROVIDERS: dict[str, DatasetProvider] = {}


def register_provider(provider: DatasetProvider) -> DatasetProvider:
    """Add (or replace) a provider under ``provider.name``."""
    _PROVIDERS[provider.name] = provider
    return provider


def get_provider(name: str) -> DatasetProvider:
    if name not in _PROVIDERS:
        raise KeyError(f"unknown dataset provider {name!r}; "
                       f"registered: {provider_names()}")
    return _PROVIDERS[name]


def provider_names() -> list[str]:
    return sorted(_PROVIDERS)


# --- built-in providers ------------------------------------------------------

for _name, _spec in har.DATASETS.items():
    register_provider(SyntheticProvider(_name, _spec["modalities"],
                                        _spec["n_classes"],
                                        _spec["n_subjects"]))

# UCF101-style A+V: a high-rate "video" feature stream (harmonic-rich, like
# the IMU generator) next to a sparse spiky "audio" track — the two-modality,
# wide-channel-gap shape of fed-multimodal's UCF101 split, 10 action classes
register_provider(SyntheticProvider(
    "ucf101_av",
    (ModalityDef("video", 12, "imu"), ModalityDef("audio", 2, "ecg")),
    classes=10, default_subjects=16))
