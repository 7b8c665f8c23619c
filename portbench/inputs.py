"""Inputs the benchmark makes from ``--seed`` and hands to the program and to
the plain reference alike: the synthetic HAR windows, the B2 weights, the
fleet, the LM weights and adapters, and the serving traffic.

Nothing here imports the program. The HAR generator is a copy of the
port's synthetic PAMAP2/MHEALTH lookalike (class-conditional harmonic
mixtures per modality, with per-subject gain, phase, noise and class
priors), so that the yardstick does not move with the program.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

WINDOW = 256
RATE_HZ = 50.0
SMALL = 1 << 26  # leaves drawn together on one buffer


# ---------------------------------------------------------------------------
# synthetic HAR windows
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HARData:
    """Per-subject training windows, as the round reads them."""
    train_x: list[np.ndarray]  # [n, WINDOW, C] float32
    train_y: list[np.ndarray]  # [n] int32


def _modality_signal(kind: str, cls: int, n_ch: int, n: int, t: np.ndarray,
                     rng: np.random.Generator, gain: float, phase: float,
                     noise: float) -> np.ndarray:
    out = np.zeros((n, WINDOW, n_ch), np.float32)
    base_f = 0.6 + 0.37 * cls
    for ch in range(n_ch):
        ph = rng.uniform(0, 2 * np.pi, size=(n, 1)) + phase + 0.9 * ch
        if kind == "imu":
            f1 = base_f * (1.0 + 0.11 * ch)
            sig = (np.sin(2 * np.pi * f1 * t[None] + ph)
                   + 0.5 * np.sin(2 * np.pi * 2 * f1 * t[None] + 1.7 * ph)
                   + 0.25 * np.sin(2 * np.pi * 3.1 * f1 * t[None]))
            amp = 1.0 + 0.3 * cls
        elif kind == "pulse":
            level = (55.0 + 7.0 * cls) / 100.0
            sig = level + 0.08 * np.sin(2 * np.pi * 0.08 * (1 + 0.2 * cls)
                                        * t[None] + ph)
            amp = 1.0
        else:  # ecg
            rate = 1.0 + 0.15 * cls
            carrier = np.sin(2 * np.pi * rate * t[None] + ph)
            sig = np.exp(-30.0 * (1 - carrier)) + 0.1 * np.sin(
                2 * np.pi * 0.3 * t[None] + ph)
            amp = 1.0
        out[..., ch] = gain * amp * sig
    out += rng.normal(0, noise, size=out.shape).astype(np.float32)
    return out


def har_data(modalities: list[dict], n_classes: int, n_subjects: int,
             windows_per_subject: int, seed: int) -> HARData:
    """One subject per client, its class priors Dirichlet(1), a quarter of
    its windows held out as the port's generator holds them out (they are
    drawn, not kept: no evaluation runs); ``modalities``: [{"name",
    "channels", "kind"}] in the model's order."""
    rng = np.random.default_rng(seed)
    t = np.arange(WINDOW, dtype=np.float32) / RATE_HZ
    tr_x, tr_y = [], []
    for _ in range(n_subjects):
        prior = rng.dirichlet(np.ones(n_classes))
        gain = float(np.exp(rng.normal(0, 0.1)))
        phase = float(rng.uniform(0, 2 * np.pi))
        noise = float(rng.uniform(0.12, 0.3))
        counts = rng.multinomial(windows_per_subject, prior)
        xs, ys = [], []
        for cls, cnt in enumerate(counts):
            if cnt == 0:
                continue
            parts = [_modality_signal(m["kind"], cls, m["channels"], cnt, t,
                                      rng, gain, phase, noise)
                     for m in modalities]
            xs.append(np.concatenate(parts, axis=-1))
            ys.append(np.full(cnt, cls, np.int32))
        x, y = np.concatenate(xs), np.concatenate(ys)
        perm = rng.permutation(len(y))
        x, y = x[perm], y[perm]
        n_te = max(1, int(0.25 * len(y)))
        tr_x.append(x[n_te:])
        tr_y.append(y[n_te:])
    return HARData(tr_x, tr_y)


# ---------------------------------------------------------------------------
# fleets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Fleet:
    """N clients: which tier each is, which modalities it holds, its TOPS."""
    tier: np.ndarray  # [N] index into the config's tiers
    modality_mask: np.ndarray  # [N, M] bool
    tops: np.ndarray  # [N] float64


def fleet(tiers: list[dict], base: list[int], n_clients: int, M: int,
          draw_seed: int) -> Fleet:
    """The paper's base fleet (``base[i]`` clients of ``tiers[i]``),
    replicated to ``n_clients`` by uniform draws over its members with a
    fixed ``draw_seed``: the deployment, the same for every run."""
    rows = [i for i, n in enumerate(base) for _ in range(n)]
    idx = np.random.default_rng(draw_seed).integers(0, len(rows),
                                                   size=n_clients)
    tier = np.array([rows[i] for i in idx], np.int64)
    mask = np.zeros((n_clients, M), bool)
    for n, ti in enumerate(tier):
        mask[n, tiers[ti]["modalities"]] = True
    tops = np.array([float(tiers[ti]["tops"]) for ti in tier])
    return Fleet(tier, mask, tops)


# ---------------------------------------------------------------------------
# weights, made on the device from the seed
# ---------------------------------------------------------------------------


def normal_leaves(specs: list[tuple[tuple, tuple[int, ...], float]],
                  seed: int, device, dtype=torch.float32) -> dict:
    """specs: [(path, shape, std)], std 0 for a zero leaf -> {path: tensor}
    in ``dtype``, drawn on ``device`` from one generator seeded by
    ``seed``: the small leaves in one call on one buffer, a large leaf one
    call per leading slice of a
    stacked one."""
    g = torch.Generator(device=device).manual_seed(seed)
    out, small = {}, []
    for path, shape, std in specs:
        if not std:
            out[path] = torch.zeros(shape, device=device, dtype=dtype)
        elif math.prod(shape) <= SMALL:
            small.append((path, shape, std))
        else:
            t = torch.empty(shape, device=device, dtype=dtype)
            for sl in (t if t.dim() > 2 else [t]):
                sl.normal_(0.0, std, generator=g)
            out[path] = t
    flat = torch.empty(sum(math.prod(s) for _, s, _ in small), device=device,
                       dtype=dtype).normal_(generator=g)
    off = 0
    for path, shape, std in small:
        n = math.prod(shape)
        out[path] = flat[off:off + n].view(shape).mul_(std)
        off += n
    return {p: out[p] for p, _, _ in specs}


def nest(flat: dict) -> dict:
    """{(k1, k2, ...): leaf} -> nested dicts."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def flatten(tree: dict, prefix: tuple = ()) -> dict:
    """Nested dicts -> {(k1, k2, ...): leaf}, keys in sorted order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# ---------------------------------------------------------------------------
# serving traffic
# ---------------------------------------------------------------------------


def log_uniform_pool(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths at evenly spaced quantiles of log-uniform [lo, hi]: every
    seed gets the same multiset of lengths, in its own order."""
    q = (np.arange(n) + 0.5) / n
    return np.floor(np.exp(np.log(lo) + q * (np.log(hi + 1) - np.log(lo)))
                    ).astype(np.int64).clip(lo, hi)


def zipf_probs(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()
