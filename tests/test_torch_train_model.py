"""The model side of the port's LM training: the loss (``api.loss_fn``,
``api.chunked_ce``) for one SMOKE configuration per family
(``_lm_train.FAMILIES``) against the JAX reference on the CPU from the
reference's weights and token batches at rtol 1e-5; remat (gradients under
a per-layer checkpoint bitwise equal to those without); the shape-only
trees (``step_fns.abstract_*``) of all ten FULL configurations against the
reference's ``jax.eval_shape`` trees; the CPU init's draws unchanged.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import hashlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _lm_train import FAMILIES, batches, configs, jj, tt, weights  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import step_fns as JSF  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import step_fns as TSF  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process: torch runs 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_fn_matches_reference(arch, chunks):
    """``loss_fn`` (llava: over the text positions after its patches;
    musicgen: [B, S, 4] labels; mixtral: + 0.01 x the aux loss) at rtol
    1e-5, and with ``loss_chunks=4`` (the chunked CE of the attention
    families; the recurrent ones ignore it, as the reference's)."""
    jcfg, tcfg = configs(arch, loss_chunks=chunks)
    w = weights(arch)
    batch = batches(jcfg, 1)[0]
    want = float(jax.jit(japi.loss_fn, static_argnums=1)(
        jax.tree.map(jnp.asarray, w), jcfg, jj(batch)))
    got = float(tapi.loss_fn(params_from_numpy(w, "cpu"), tcfg, tt(batch)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_chunked_ce_equals_the_whole_ce():
    """The chunked CE is the CE of the whole sequence: the mean of equal
    chunks' means."""
    _, tcfg = configs("phi3-medium-14b")
    params = params_from_numpy(weights("phi3-medium-14b"), "cpu")
    batch = tt(batches(tcfg, 1)[0])
    h, _, _ = tapi.forward_hidden(params, tcfg, batch)
    whole = tapi.chunked_ce(params, tcfg, h, batch["labels"], 1)
    torch.testing.assert_close(
        tapi.chunked_ce(params, tcfg, h, batch["labels"], 4), whole,
        rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="divisible"):
        tapi.chunked_ce(params, tcfg, h, batch["labels"], 5)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gradients_equal_no_remat_bitwise(arch, remat):
    """Every parameter's gradient under a per-layer checkpoint equals the
    gradient without one, bitwise (the recompute runs the same CPU ops on
    the same values)."""
    _, tcfg = configs(arch)
    batch = tt(batches(tcfg, 1)[0])
    w = weights(arch)
    grads = {}
    for mode in ("none", remat):
        params = params_from_numpy(w, "cpu")
        flat = [t.requires_grad_() for t in leaves(params)]
        loss = tapi.loss_fn(params, dataclasses.replace(tcfg, remat=mode),
                            batch)
        grads[mode] = torch.autograd.grad(loss, flat, allow_unused=True)
    for a, b in zip(grads["none"], grads[remat]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_remat_needs_a_forward_without_caches():
    """A checkpointed layer must not write its cache in place (the
    recompute would write it again): remat raises with caches, and a
    forward without a gradient (serving) takes no checkpoint at all."""
    _, tcfg = configs("phi3-medium-14b", remat="dots")
    params = params_from_numpy(weights("phi3-medium-14b"), "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    caches = tapi.init_caches(tcfg, 1, 8, device="cpu")
    params["lora"]["layers"]["wq"]["a"].requires_grad_()
    with pytest.raises(ValueError, match="without caches"):
        tapi.TF.lm_forward(params, tcfg, tokens, caches=caches)
    with torch.no_grad():
        tapi.TF.lm_forward(params, tcfg, tokens, caches=caches)
    with pytest.raises(ValueError, match="unknown remat"):
        tapi.loss_fn(params, dataclasses.replace(tcfg, remat="some"),
                     {"tokens": tokens, "labels": tokens})


# ---------------------------------------------------------------------------
# shape-only trees
# ---------------------------------------------------------------------------


def _shape_dtypes_equal(jtree, ttree):
    jl = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
          for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    tl = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
          for p, x in leaves_with_path(ttree)]
    assert jl == tl


@pytest.mark.parametrize("arch", sorted(tbase.list_archs()))
def test_abstract_trees_match_reference_at_full_width(arch):
    """``abstract_params`` (and the LoRA tree's Adam moments, and the decode
    caches) of every FULL config: the reference's ``jax.eval_shape`` trees,
    path for path, shape and dtype, on ``meta`` (no memory)."""
    jcfg, tcfg = jbase.get_arch(arch).FULL, tbase.get_arch(arch).FULL
    jp, tp = JSF.abstract_params(jcfg), TSF.abstract_params(tcfg)
    assert {t.device.type for t in leaves(tp)} == {"meta"}
    _shape_dtypes_equal(jp, tp)
    jo = JSF.abstract_opt_state(jp["lora"])
    to = TSF.abstract_opt_state(tp["lora"])
    for k in ("m", "v"):
        _shape_dtypes_equal(jo[k], to[k])
    tc = TSF.abstract_caches(tcfg, 2, 64)
    assert {t.device.type for t in leaves(tc)} == {"meta"}
    _shape_dtypes_equal(JSF.abstract_caches(jcfg, 2, 64), tc)


# sha256 (first 16 hex digits) of every SMOKE config's CPU init from seed 0
# (paths and raw bytes of each leaf), computed before init learned to skip
# its draws on meta
INIT_SHA = {
    "gemma2-27b": "65d8d492df0dfa6f", "granite-3-8b": "dccf648e0ddc6f20",
    "granite-34b": "84f35b65678f6379", "hymba-1.5b": "9ecd717c11c97771",
    "llava-next-34b": "d8149d497f844686", "mamba2-1.3b": "90c68b27cfb28360",
    "mixtral-8x22b": "f0343d416e3ffec4", "mixtral-8x7b": "f0343d416e3ffec4",
    "musicgen-large": "f2b39b724cb01edf",
    "phi3-medium-14b": "50de64b2d5b308ea",
}


@pytest.mark.parametrize("arch", sorted(INIT_SHA))
def test_init_model_on_cpu_draws_as_before(arch):
    p = tapi.init_model(torch.Generator().manual_seed(0),
                        tbase.get_arch(arch).SMOKE, "cpu")
    h = hashlib.sha256()
    for path, t in leaves_with_path(p):
        h.update(path.encode())
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        h.update(raw.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest()[:16] == INIT_SHA[arch]
