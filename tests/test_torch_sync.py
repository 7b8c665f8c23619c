"""The port's synchronous round (``FedRun``) on Backbone 2, and the fused
block-LoRA projection under it, against the JAX reference on the CPU.

Both packages get the same numpy inputs and the reference's initial
weights (``convert.params_from_numpy``); on CPU tensors the port runs the
plain version of the fused kernel through the same autograd Function that
launches the CUDA kernel on the card."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import relief_har as JC  # noqa: E402
from repro.core import aggregation as JAG  # noqa: E402
from repro.core import divergence as JDV  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import mdlora as JMD  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.core.tasks import MMTask as JTask  # noqa: E402
from repro.data import make_har_dataset as j_dataset  # noqa: E402
from repro.kernels.mdlora.ops import mdlora_matmul as j_mdlora  # noqa: E402
from repro.models import multimodal as JMM  # noqa: E402
from repro.sim import make_fleet as j_fleet  # noqa: E402
from repro_torch.configs import relief_har as TC  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.core import aggregation as TAG  # noqa: E402
from repro_torch.core import async_engine as TA  # noqa: E402
from repro_torch.core import divergence as TDV  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import mdlora as TMD  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core.tasks import MMTask as TTask  # noqa: E402
from repro_torch.data import make_har_dataset as t_dataset  # noqa: E402
from repro_torch.kernels.mdlora import ops as md_ops  # noqa: E402
from repro_torch.kernels.mdlora.autograd import fused_block_lora  # noqa: E402
from repro_torch.kernels.mdlora.ref import mdlora_matmul_ref  # noqa: E402
from repro_torch.models import multimodal as TMM  # noqa: E402
from repro_torch.sim import make_fleet as t_fleet  # noqa: E402
from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402

# the round of tests/test_engine.py, made shorter
KW = dict(rounds=2, local_epochs=1, steps_per_epoch=2, batch_size=8,
          eval_every=100, utilization=1e-4, seed=0)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process, so torch's CPU ops run 2
    threads: with all 8 they contend with it and run ~4x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def b2():
    """PAMAP2_B2_SMALL: the reference's task and weights, and the port's
    task built from the same weights."""
    jtask, jtr0 = JTask.create(JC.PAMAP2_B2_SMALL, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtask.params(jtr0))
    ttask, ttr0 = TTask.create(TC.PAMAP2_B2_SMALL, params=params,
                               device="cpu")
    return jtask, jtr0, ttask, ttr0


@pytest.fixture(scope="module")
def datasets():
    return (j_dataset("pamap2", windows_per_subject=60, seed=0),
            t_dataset("pamap2", windows_per_subject=60, seed=0))


def _assert_trees_close(jtree, ttree, atol, rtol=0.0):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = leaves_with_path(params_to_numpy(ttree))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(p))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# the fused projection (TPU kernel 3)
# ---------------------------------------------------------------------------

BLOCKS = {112: [32, 32, 32, 16], 100: [40, 30, 20, 10], 128: [64, 32, 32]}
# fp32: sums over D in another order; bf16: x, W0, a, b and y in bf16
# (test_kernels.py:19-37 holds the Pallas kernel to the same)
FUSED_TOL = {"fp32": 1e-5, "bf16": 3e-2}


@pytest.mark.parametrize("T,D,F,r,dtype,poison", [
    (32, 112, 128, 8, "fp32", False),  # the training path's shape
    (32, 112, 128, 8, "bf16", False),
    (37, 100, 70, 5, "fp32", False),  # ragged T, D, F
    (37, 100, 70, 5, "bf16", False),
    (64, 128, 64, 8, "fp32", True),  # absent rows poisoned with 100x noise
], ids=["path-fp32", "path-bf16", "ragged-fp32", "ragged-bf16", "poison"])
def test_plain_fused_projection_matches_reference(T, D, F, r, dtype, poison):
    g = np.random.default_rng(T + D + F + r)
    x = g.normal(size=(T, D)).astype(np.float32)
    w0 = (0.05 * g.normal(size=(D, F))).astype(np.float32)
    a = (0.1 * g.normal(size=(D, r))).astype(np.float32)
    b = (0.1 * g.normal(size=(r, F))).astype(np.float32)
    mm = [1.0, 0.0, 1.0, 0.0][:len(BLOCKS[D])]
    mask = np.repeat(np.array(mm, np.float32), BLOCKS[D])
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    jargs = [jnp.asarray(v, jdt) for v in (x, w0, a, b)]
    want_x = j_mdlora(*jargs, jnp.asarray(mask), impl="xla")
    want_p = j_mdlora(*jargs, jnp.asarray(mask), impl="pallas",
                      interpret=True)
    targs = [_t(v, tdt) for v in (x, w0, a, b)]
    got = md_ops.mdlora_matmul(*targs, _t(mask), 2.0)
    assert got.dtype == tdt and tuple(got.shape) == (T, F)
    tol = FUSED_TOL[dtype]
    for want in (want_x, want_p):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    if poison:  # absent rows must not reach y at all
        x2 = x + (1.0 - mask) * 100.0 * g.normal(size=(T, D)).astype(
            np.float32)
        got2 = md_ops.mdlora_matmul(_t(x2), *targs[1:], _t(mask), 2.0)
        np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=1e-5)


def _fused_inputs(K, T, D, F, r, seed, dtype=torch.float32):
    g = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a).to(dtype)  # noqa: E731
    x = t(g.normal(size=(K, T, D)))
    w0 = t(0.1 * g.normal(size=(D, F)))
    a = t(0.3 * g.normal(size=(K, D, r)))
    b = t(0.3 * g.normal(size=(K, r, F)))
    blocks = [D // 4] * 3 + [D - 3 * (D // 4)]
    mm = (g.random((K, 4)) < 0.6).astype(np.float32)
    mm[:, 0] = 1.0
    mask = t(np.repeat(mm, blocks, axis=1))
    return x, w0, a, b, mask


def test_fused_function_gradcheck():
    """fp64 gradcheck of dx, dW0, da, db (the plain version accumulates in
    fp64 for fp64 inputs), with an absent block in the mask."""
    x, w0, a, b, mask = _fused_inputs(1, 5, 12, 7, 3, 0, torch.float64)
    args = [t[0] if t.dim() == 3 else t for t in (x, w0, a, b)]
    args = [t.clone().requires_grad_(True) for t in args]
    m = mask[0].clone()
    m[3:6] = 0.0
    assert torch.autograd.gradcheck(
        lambda *xs: fused_block_lora(*xs, m, 2.0), tuple(args))


def _vmap_grads(fn, x, w0, a, b, mask):
    def loss(a_, b_, x_, m_):
        return torch.tanh(fn(x_, w0, a_, b_, m_, 2.0)).square().sum()
    return torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
        a, b, x, mask)


def test_fused_function_vmap_grad_matches_plain_expression():
    """vmap(grad) over 8 clients through the Function (its vmap rule: one
    batched call, W0 shared) equals vmap(grad) through the plain expression
    to 1e-6 (the same products, summed in the same order on the CPU)."""
    args = _fused_inputs(8, 32, 112, 128, 8, 1)
    got = _vmap_grads(fused_block_lora, *args)
    want = _vmap_grads(mdlora_matmul_ref, *args)
    for name, g, w in zip(("da", "db", "dx"), got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6, msg=name)


def test_fused_function_absent_rows_get_exactly_zero_gradient():
    """Rows of da and dx for absent blocks are exactly 0, even where x holds
    large values (Eq. 1/2; Assumption 4 with eps_0 = 0)."""
    x, w0, a, b, mask = _fused_inputs(8, 32, 112, 128, 8, 2)
    x = x + (1.0 - mask[:, None, :]) * 1e4
    da, db, dx = _vmap_grads(fused_block_lora, x, w0, a, b, mask)
    absent = mask == 0
    assert absent.any() and (da != 0).any()
    assert (da[absent] == 0).all()
    assert (dx.transpose(1, 2)[absent] == 0).all()
    assert torch.isfinite(db).all()


# ---------------------------------------------------------------------------
# Backbone 2: logits, gradients, layout
# ---------------------------------------------------------------------------


def _batch(seed, n=16):
    cfg = TC.PAMAP2_B2_SMALL
    g = np.random.default_rng(seed)
    x = g.normal(size=(n, cfg.window, cfg.total_channels)).astype(np.float32)
    y = g.integers(0, cfg.n_classes, n)
    return x, y


@pytest.mark.parametrize("mask", [[1, 1, 1, 1], [1, 0, 1, 0]],
                         ids=["full", "partial"])
def test_b2_small_logits_match_reference(b2, mask):
    jtask, jtr0, ttask, ttr0 = b2
    x, _ = _batch(0)
    mm = np.array([mask], np.float32)
    want = JMM.mm_forward(jtask.params(jtr0), jtask.cfg, jnp.asarray(x),
                          jnp.asarray(mm))
    got = TMM.mm_forward(ttask.params(ttr0), ttask.cfg, torch.as_tensor(x),
                         torch.as_tensor(mm))
    # fp32, 2 encoder layers of width 32: sums in another order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def _perturbed(tree, seed):
    """Non-zero LoRA b leaves, so every adapter has a gradient."""
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.05 * g.normal(size=v.shape).astype(np.float32)
        if jax.tree_util.keystr(p).endswith("['b']") else v, tree)


def test_b2_small_client_gradients_match_reference(b2):
    """Per-client vmap(value_and_grad) of the loss over 8 clients with the
    fleet's modality masks: losses and every trainable gradient to
    atol 2e-6 + rtol 1e-4 (fp32)."""
    jtask, jtr0, ttask, _ = b2
    K = 8
    tr = _perturbed(jax.tree.map(np.asarray, jtr0), 3)
    stack = jax.tree.map(lambda v: np.broadcast_to(v, (K,) + v.shape), tr)
    x = np.stack([_batch(10 + k, 8)[0] for k in range(K)])
    y = np.stack([_batch(10 + k, 8)[1] for k in range(K)])
    mm = j_fleet(3, 3, 2, M=4).modality_mask.astype(np.float32)

    def jloss(t, x, y, m):
        return jtask.loss(t, {"x": x, "y": y, "modality_mask": m})

    jl, jg = jax.vmap(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, stack), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(mm))

    def tloss(t, x, y, m):
        return ttask.loss(t, {"x": x, "y": y, "modality_mask": m})

    tstack = tree_map(lambda v: torch.as_tensor(np.ascontiguousarray(v)),
                      stack)
    tg, tl = torch.func.vmap(torch.func.grad_and_value(tloss))(
        tstack, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(mm))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    _assert_trees_close(jg, tg, atol=2e-6, rtol=1e-4)


def test_b2_group_layout_matches_reference(b2):
    jtask, _, ttask, _ = b2
    jl, tl = jtask.layout, ttask.layout
    assert tl.names == jl.names and tl.kinds == jl.kinds
    assert [n for n in tl.names if n.startswith("E_")] == [
        f"E_{m}_L{i}" for m in ("acc", "gyro", "hr", "mag") for i in (0, 1)]
    np.testing.assert_array_equal(tl.modality, jl.modality)
    np.testing.assert_array_equal(tl.sizes, jl.sizes)
    np.testing.assert_allclose(tl.flops, jl.flops, rtol=1e-12)
    assert tl.leaf_group == jl.leaf_group
    assert tl.fusion_a_path == jl.fusion_a_path == "['lora']['fusion']['a']"
    assert tl.fusion_rows == jl.fusion_rows
    assert tl.leaf_axis0_groups.keys() == jl.leaf_axis0_groups.keys()
    assert len(tl.leaf_axis0_groups) == 4 * 3 * 2  # modalities x wq/wv/wi x a/b
    for p, ids in jl.leaf_axis0_groups.items():
        np.testing.assert_array_equal(tl.leaf_axis0_groups[p], ids)
    np.testing.assert_allclose(ttask.forward_flops_per_example(),
                               jtask.forward_flops_per_example(), rtol=1e-12)


def test_gate_tree_reaches_every_encoder_layer_group(b2):
    """Each E_{m}_L{l} group's gradient is non-zero when gated on and zero
    when gated off (a leaf the layout missed would be zeroed silently)."""
    _, jtr0, ttask, _ = b2
    layout = ttask.layout
    x, y = _batch(5, 8)
    trainable = tree_map(torch.tensor, _perturbed(
        jax.tree.map(np.asarray, jtr0), 4))
    grads = torch.func.grad(lambda t: ttask.loss(t, {
        "x": torch.as_tensor(x), "y": torch.as_tensor(y),
        "modality_mask": torch.ones(4)}))(trainable)
    enc = [g for g, n in enumerate(layout.names) if n.startswith("E_")]
    assert len(enc) == 8
    for g in enc:
        gate = torch.zeros(layout.G)
        gate[g] = 1.0
        on = TMD.group_norms(layout, TMD.group_gate_tree(layout, grads, gate))
        assert on[g] > 0, layout.names[g]
        assert (on[torch.arange(layout.G) != g] == 0).all()
        off = TMD.group_norms(layout,
                              TMD.group_gate_tree(layout, grads, 1.0 - gate))
        assert off[g] == 0 and (off > 0).sum() == layout.G - 1


# ---------------------------------------------------------------------------
# server math: divergence, aggregation, Lemma 1
# ---------------------------------------------------------------------------


def _deltas(tr0, N, seed):
    g = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: g.normal(size=(N,) + np.shape(v)).astype(np.float32), tr0)


def test_server_math_matches_reference(b2):
    """group_divergence, cohort/fedavg weights, aggregate and
    weighted_combine over 8 stacked B2 client deltas, and Lemma 1 on one
    fusion block: fp32 reductions in another order, atol/rtol 1e-5."""
    jtask, jtr0, ttask, ttr0 = b2
    N, G = 8, jtask.layout.G
    d_np = _deltas(jax.tree.map(np.asarray, jtr0), N, 7)
    g = np.random.default_rng(8)
    S = g.random((N, G)) < 0.7
    mm = j_fleet(3, 3, 2, M=4).modality_mask.astype(np.float32)
    cohort = (jtask.layout.accessible(mm) & S).astype(np.float32)
    jd = jax.tree.map(jnp.asarray, d_np)
    td = tree_map(torch.tensor, d_np)
    close = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        TDV.group_divergence(ttask.layout, td, torch.as_tensor(cohort)),
        np.asarray(JDV.group_divergence(jtask.layout, jd, cohort)), **close)
    jW = JAG.cohort_weights(jtask.layout, S, mm)
    tW = TAG.cohort_weights(ttask.layout, torch.as_tensor(S),
                            torch.as_tensor(mm))
    np.testing.assert_allclose(tW.numpy(), np.asarray(jW), **close)
    part = (g.random(N) < 0.8).astype(np.float32)
    np.testing.assert_allclose(
        TAG.fedavg_weights(N, G, torch.as_tensor(part)).numpy(),
        np.asarray(JAG.fedavg_weights(N, G, part)), **close)
    _assert_trees_close(JMD.weighted_combine(jtask.layout, jd, jW),
                        TMD.weighted_combine(ttask.layout, td, tW), **close)
    _assert_trees_close(
        JAG.aggregate(jtask.layout, jtr0, jd, jW, 0.5),
        TAG.aggregate(ttask.layout, ttr0, td, tW, 0.5), **close)
    block = d_np["lora"]["fusion"]["a"][:, :16]  # [N, d_acc, r]
    c = mm[:, 1] > 0  # the gyro cohort
    jl = JAG.lemma1_decomposition(block, c)
    tl = TAG.lemma1_decomposition(torch.as_tensor(block), torch.as_tensor(c))
    assert tl.keys() == jl.keys()
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(tl["error"]) <= float(tl["bound"])


# ---------------------------------------------------------------------------
# the synchronous round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["relief", "fedavg", "helora", "fedlease"])
def test_fedrun_two_rounds_match_reference(b2, datasets, name):
    """Two FedRun rounds on PAMAP2_B2_SMALL, paper fleet (3,3,2), 10%
    client dropout: the same participants, selections, simulated time and
    upload; losses, divergence EMA and the global (and, for the
    personalized fedlease, per-client) trainable to 1e-5."""
    jtask, jtr0, ttask, ttr0 = b2
    jds, tds = datasets
    runs = []
    for E, S, task, tr0, fleet in ((JE, JS, jtask, jtr0, j_fleet),
                                   (TE, TS, ttask, ttr0, t_fleet)):
        run = E.FedRun.create(task, tr0, S.get(name), fleet(3, 3, 2, M=4),
                              E.FedConfig(dropout_prob=0.1, **KW))
        recs = [run.round(ds) for ds in ((jds, tds)[E is TE],) * 2]
        runs.append((run, recs))
    (jrun, jrecs), (trun, trecs) = runs
    for jr, tr in zip(jrecs, trecs):
        for key in ("round", "selected_frac", "round_time_s", "upload_mb",
                    "fleet_energy_j"):
            assert tr[key] == pytest.approx(jr[key], rel=1e-12), key
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-5)
        np.testing.assert_allclose(tr["divergence"], jr["divergence"],
                                   rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(trun.state.dbar, jrun.state.dbar, rtol=1e-5,
                               atol=1e-9)
    _assert_trees_close(jrun.state.trainable, trun.state.trainable,
                        atol=1e-5, rtol=1e-5)
    if name == "fedlease":  # the cluster-mixed personal LoRA leaves
        _assert_trees_close(jrun.state.client_trainable["lora"],
                            trun.state.client_trainable["lora"],
                            atol=1e-5, rtol=1e-5)


ALL_STRATEGIES = sorted(set(TS.ALL_BASELINES) | set(TS.ABLATIONS)
                        | {"relief"})


@pytest.mark.parametrize("name", ALL_STRATEGIES)
def test_every_strategy_runs(b2, datasets, name):
    """Every strategy of core/strategies.py runs through the port's FedRun
    on Backbone 2 (the reference's test_engine.py:32, at PAMAP2_B2_SMALL)."""
    _, _, ttask, ttr0 = b2
    run = TE.FedRun.create(ttask, ttr0, TS.get(name), t_fleet(3, 3, 2, M=4),
                           TE.FedConfig(**(KW | {"eval_every": 2})))
    h = run.run(datasets[1])
    assert len(h["round_time_s"]) == KW["rounds"]
    assert np.isfinite(h["loss"]).all()
    assert 0.0 <= h["f1"][-1] <= 1.0
    assert h["round_time_s"][-1] > 0 and h["upload_mb"][-1] >= 0


def test_b1_round_equals_async_flush_bitwise(datasets):
    """Homogeneous fleet, buffer K = N, no staleness discount: one round of
    the port's FedRun gives its AsyncFedRun's global trainable bit for bit
    (the reference's anchor, test_async_engine.py:53)."""
    _, tds = datasets
    cfg = TC.PAMAP2_B1_SMALL
    fleet = t_fleet(4, 0, 0, M=4)
    kw = dict(rounds=1, local_epochs=1, steps_per_epoch=2, batch_size=8,
              eval_every=10, seed=0)
    out = []
    for make in (lambda t, tr: TE.FedRun.create(t, tr, TS.get("relief"),
                                                fleet, TE.FedConfig(**kw)),
                 lambda t, tr: TA.AsyncFedRun.create(
                     t, tr, TS.async_relief(buffer_size=fleet.N,
                                            staleness_exponent=0.0),
                     fleet, TA.AsyncFedConfig(**kw))):
        task, tr0 = TTask.create(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        run = make(task, tr0)
        if isinstance(run, TE.FedRun):
            run.round(tds)
        else:
            run.run(tds, total_updates=fleet.N)
            assert run.state.round == 1
        out.append(leaves_with_path(run.state.trainable))
    for (p, a), (_, b) in zip(*out):
        assert torch.equal(a, b), p


def test_entry_point_runs_on_cpu(capsys):
    """The slice end to end through its entry point: Backbone 2 small,
    two rounds, the plain versions."""
    from repro_torch.launch import train_relief_har

    hist = train_relief_har.main(["--device", "cpu", "--small", "--rounds",
                                  "2"])
    assert hist["round"] == [1, 2] and np.isfinite(hist["loss"]).all()
    assert 0.0 <= hist["f1"][-1] <= 1.0
    out = capsys.readouterr().out
    assert "pamap2/b2" in out and "per-modality F1" in out


def test_async_runtime_refuses_backbone2(b2):
    """Backbone 2 is no longer refused by the async runtimes: both build on
    it, the buffer takes its layer-stacked groups, and selective upload is
    taken too (by the vectorized runtime in grad mode "dispatch" only, as
    in the reference)."""
    _, _, ttask, ttr0 = b2
    assert ttask.layout.leaf_axis0_groups
    for run_cls in (TA.AsyncFedRun, TA.VectorizedAsyncFedRun):
        for strat in (TS.async_relief(), TS.relief_selective()):
            run = run_cls.create(ttask, ttr0, strat, t_fleet(2, 0, 0, M=4),
                                 TA.AsyncFedConfig(rounds=1))
            assert run.aggbuf.layout is ttask.layout
    with pytest.raises(ValueError, match="selective upload"):
        TA.VectorizedAsyncFedRun.create(
            ttask, ttr0, TS.relief_selective(), t_fleet(2, 0, 0, M=4),
            TA.AsyncFedConfig(rounds=1, grad_mode="cohort"))
