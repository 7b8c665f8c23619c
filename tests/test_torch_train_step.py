"""The port's LM train step (``launch/step_fns.py``) and its MoE gradient
against the JAX reference on the CPU, for one SMOKE configuration per
family (``_lm_train.FAMILIES``: dense phi3-medium-14b and gemma2-27b, moe
mixtral-8x7b, vlm llava-next-34b, audio musicgen-large, ssm mamba2-1.3b,
hybrid hymba-1.5b), from the reference's weights and token batches.

Tolerances (fp32): losses and gradient norms 1e-5 relative. The Adam
moments m and v: rtol 1e-4 plus an atol of 1e-4 x the leaf's largest
magnitude (a gradient element is a sum whose terms cancel; summed in
another order, its error scales with the leaf's gradients, not with the
element: measured at most 6.4e-5 of the leaf's largest). Parameters: atol
2e-6 + rtol 1e-4, with one stated exception. Adam's step is lr * m_hat /
(sqrt(v_hat) + eps), ~lr * sign(g) at step 1, so where a gradient is near
its own rounding error that error decides the step: up to 2 * lr per step.
An element is held through m and v, and its value only within that bound
(2 * lr * steps), when its gradient at some step was below ``TINY_GRAD`` =
1e-4 of its leaf's largest, ~1.5x the rounding measured above (the
gradients are read off the port's m: g_t = (m_t - 0.9 m_(t-1)) / 0.1). The
elements that missed 2e-6 + 1e-4 had gradients at most 1.2e-5 of their
leaf's largest.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _lm_train import (FAMILIES, assert_close, batches, configs,  # noqa: E402
                       jj, tleaves, tt, weights)

from repro.launch import step_fns as JSF  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.optim import adam_init as j_adam_init  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.mdlora import ops as md_ops  # noqa: E402
from repro_torch.kernels.mdlora import ref as md_ref  # noqa: E402
from repro_torch.kernels.mdlora.autograd import fused_block_lora  # noqa: E402
from repro_torch.launch import step_fns as TSF  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.optim import adam_init as t_adam_init  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

STEPS, LR = 3, 1e-3
TINY_GRAD = 1e-4
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process: torch runs 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _tiny_masks(ms):
    """Per trainable leaf, the elements whose gradient at some step was
    below TINY_GRAD of the leaf's largest, from the port's m after each
    step (m_t = 0.9 m_(t-1) + 0.1 g_t)."""
    masks, prev = {}, None
    for m in ms:
        for i, (p, a) in enumerate(tleaves(m)):
            g = np.abs(a - (0.0 if prev is None else 0.9 * prev[i][1]))
            tiny = g < TINY_GRAD * g.max(initial=0.0)
            masks[p] = masks.get(p, False) | tiny
        prev = tleaves(m)
    return masks


@pytest.mark.parametrize("mode", ["lora", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch, mode):
    """Three steps of ``make_train_step`` against the reference's jitted
    step from the same weights and batches: loss and grad_norm at rtol
    1e-5 every step; after the last, Adam's m and v, and the parameters by
    the rule in the module docstring; the frozen base (lora) untouched, the
    very tensors passed in."""
    jcfg, tcfg = configs(arch)
    w = weights(arch)
    jparams = jax.tree.map(jnp.asarray, w)
    tparams = params_from_numpy(w, "cpu")
    jtr, _ = JSF.split_trainable(jparams, mode)
    ttr, _ = TSF.split_trainable(tparams, mode)
    jopt, topt = j_adam_init(jtr), t_adam_init(ttr)
    jstep = jax.jit(JSF.make_train_step(jcfg, lr=LR, train_mode=mode))
    tstep = TSF.make_train_step(tcfg, lr=LR, train_mode=mode)
    base_in = leaves(tparams["base"])
    ms = []
    for batch in batches(jcfg, STEPS):
        jparams, jopt, jm = jstep(jparams, jopt, jj(batch))
        tparams, topt, tm = tstep(tparams, topt, tt(batch))
        ms.append(topt["m"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=LOSS_RTOL)
    assert topt["t"] == int(jopt["t"]) == STEPS
    for k in ("m", "v"):
        assert_close(jopt[k], topt[k], atol=0.0, rtol=1e-4, leaf_atol=1e-4)
    jtr, _ = JSF.split_trainable(jparams, mode)
    ttr, _ = TSF.split_trainable(tparams, mode)
    tiny = _tiny_masks(ms)
    assert_close(jtr, ttr, atol=2e-6, rtol=1e-4, skip=tiny)
    assert_close(jtr, ttr, atol=2 * LR * STEPS, rtol=0.0)
    if mode == "lora":
        assert all(a is b for a, b in zip(leaves(tparams["base"]), base_in))
        assert not any(t.requires_grad for t in leaves(tparams))


def test_moe_layer_gradient_with_capacity_drops():
    """``jax.grad`` of the reference's sparse MoE layer against the port's
    autograd, at a capacity that drops assignments: the gradients of the
    router (through the gates and the aux loss), the experts and x at
    1e-5; a dropped assignment contributes nothing."""
    g = np.random.default_rng(4)
    Bm, Sm, d, f, E, k, cf = 2, 24, 16, 32, 4, 2, 0.5
    p = {"router": g.normal(size=(d, E)).astype(np.float32) / 4,
         "wi": g.normal(size=(E, d, f)).astype(np.float32) / 4,
         "wg": g.normal(size=(E, d, f)).astype(np.float32) / 4,
         "wo": g.normal(size=(E, f, d)).astype(np.float32) / 6}
    x = (g.normal(size=(Bm, Sm, d)) + 0.5 * g.normal(size=d)).astype(
        np.float32)
    cot = g.normal(size=(Bm, Sm, d)).astype(np.float32)

    def jloss(p, x):
        out, aux = JMOE.moe_mlp(p, x, top_k=k, capacity_factor=cf)
        return jnp.sum(out * cot) + aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {n: torch.tensor(v, requires_grad=True) for n, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = TMOE.moe_mlp(tp, tx, top_k=k, capacity_factor=cf)
    (out * torch.as_tensor(cot)).sum().add(aux).backward()
    cap = TMOE.capacity(Sm, k, E, cf)
    _, _, ids = TMOE.route(tp, tx.detach(), k)
    _, rank, _ = TMOE.dispatch(ids, E, cap)
    assert int((rank >= cap).sum()) > 0  # drops present
    for n in p:
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(jg[0][n]),
                                   atol=1e-5, rtol=1e-5, err_msg=n)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the no-backward guard
# ---------------------------------------------------------------------------


def test_refuse_backward_rule():
    """A kernel call raises when grad mode is on and an input requires a
    gradient, and only then (the card's kernels call this before they
    launch; CPU tensors never reach it)."""
    x, y = torch.ones(3), torch.ones(3, requires_grad=True)
    runtime.refuse_backward("op", x, None)
    with pytest.raises(RuntimeError, match="op: the CUDA kernel has no "
                                           "backward"):
        runtime.refuse_backward("op", x, y)
    with torch.no_grad():
        runtime.refuse_backward("op", x, y)


def test_fused_function_forward_passes_the_guard(monkeypatch):
    """``FusedBlockLoRA.forward`` runs with grad mode off, under autograd
    and under ``vmap(grad)``: kernel 3's training path passes the guard,
    and its gradients are the plain expression's."""
    real = md_ops.mdlora_matmul
    calls = []

    def guarded(x, w0, a, b, row_mask, scale):
        runtime.refuse_backward("mdlora_matmul", x, w0, a, b, row_mask)
        calls.append(x.shape)
        return real(x, w0, a, b, row_mask, scale)

    monkeypatch.setattr(md_ops, "mdlora_matmul", guarded)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 12), generator=g)
    w0, a = torch.randn((12, 7), generator=g), torch.randn((3, 12, 4),
                                                           generator=g)
    b, m = torch.randn((3, 4, 7), generator=g), torch.ones(12)

    def loss(a, b, x):
        return fused_block_lora(x, w0, a, b, m, 2.0).square().sum()

    ga = torch.func.vmap(torch.func.grad(loss))(a, b, x)
    leaf = a.clone().requires_grad_()
    loss(leaf, b, x).backward()
    want = a.clone().requires_grad_()
    md_ref.mdlora_matmul_ref(x, w0, want, b, m, 2.0).square().sum() \
        .backward()
    assert len(calls) == 2
    torch.testing.assert_close(leaf.grad, want.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ga, want.grad, rtol=1e-5, atol=1e-5)
