"""Synthetic LM token streams for backbone training and serving.

A copy of ``repro/data/tokens.py`` with the same numpy draws, so both
packages train on the same batches from a seed: a sparse order-1 Markov
chain gives learnable structure (example losses visibly fall) without any
external corpus. Batches are numpy arrays; the launcher moves them to the
device.
"""
from __future__ import annotations

from collections.abc import Iterator

import numpy as np


def synthetic_token_batches(vocab: int, batch: int, seq_len: int, steps: int,
                            seed: int = 0, n_codebooks: int = 0
                            ) -> Iterator[dict[str, np.ndarray]]:
    """``steps`` batches of {"tokens", "labels"} int32 [batch, seq_len]
    (labels are the tokens shifted by one); with ``n_codebooks`` each
    position carries that many codebook streams, [batch, seq_len,
    n_codebooks], codebook c being the stream shifted by 7c mod vocab."""
    rng = np.random.default_rng(seed)
    k = min(vocab, 8)
    nxt = rng.integers(0, vocab, size=(vocab, k))
    for _ in range(steps):
        shape = (batch, seq_len + 1)
        toks = np.zeros(shape, np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=batch)
        choices = rng.integers(0, k, size=shape)
        for tpos in range(1, seq_len + 1):
            toks[:, tpos] = nxt[toks[:, tpos - 1], choices[:, tpos]]
        if n_codebooks:
            cb = np.stack([(toks + 7 * c) % vocab for c in range(n_codebooks)],
                          axis=-1)
            yield {"tokens": cb[:, :-1], "labels": cb[:, 1:]}
        else:
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
