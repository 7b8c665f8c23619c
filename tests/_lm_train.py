"""Shared inputs of the LM train tests (``test_torch_train_step.py``,
``test_torch_train_loss.py``): one SMOKE configuration per family, the
reference's weights with LoRA b perturbed (so every adapter has a gradient
at step 1), the reference's token batches, and leaf-by-leaf comparison of a
JAX tree with a port tree."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.data.tokens import synthetic_token_batches
from repro.models import api as japi
from repro_torch.configs import base as tbase
from repro_torch.tree import leaves_with_path

FAMILIES = ["phi3-medium-14b", "gemma2-27b", "mixtral-8x7b",
            "llava-next-34b", "musicgen-large", "mamba2-1.3b", "hymba-1.5b"]
B, S = 2, 32  # S: a multiple of the SMOKE SSD chunks (16)


def configs(arch, **kw):
    """-> (the reference's SMOKE config, the port's), with ``kw`` set."""
    return (dataclasses.replace(jbase.get_arch(arch).SMOKE, **kw),
            dataclasses.replace(tbase.get_arch(arch).SMOKE, **kw))


_WEIGHTS = {}


def weights(arch):
    """The reference's SMOKE weights (numpy), LoRA b perturbed."""
    if arch not in _WEIGHTS:
        jcfg, _ = configs(arch)
        p = japi.init_model(jax.random.PRNGKey(0), jcfg)
        p["lora"] = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(
            jax.random.PRNGKey(1), x.shape, x.dtype), p["lora"])
        _WEIGHTS[arch] = jax.tree.map(np.asarray, p)
    return _WEIGHTS[arch]


def batches(cfg, n, seed=0):
    """n batches of numpy arrays from the reference's token stream; llava's
    carry seeded patch embeddings."""
    g = np.random.default_rng(seed + 7)
    out = []
    for b in synthetic_token_batches(cfg.vocab, B, S, n, seed=seed,
                                     n_codebooks=cfg.n_codebooks):
        if cfg.family == "vlm":
            b["patches"] = g.normal(
                size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def tt(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def jj(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def jleaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def tleaves(tree):
    return [(p, x.detach().numpy()) for p, x in leaves_with_path(tree)]


def assert_close(jtree, ttree, atol, rtol, skip=None, leaf_atol=0.0):
    """Leaf by leaf, paths and dtypes equal, values at atol + leaf_atol *
    max|reference leaf| and rtol, leaving out the elements ``skip[path]``
    marks."""
    jl, tl = jleaves(jtree), tleaves(ttree)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert a.dtype == b.dtype, p
        tol = atol + leaf_atol * float(np.abs(a).max(initial=0.0))
        if skip is not None:
            a, b = a[~skip[p]], b[~skip[p]]
        np.testing.assert_allclose(b, a, atol=tol, rtol=rtol, err_msg=p)
