"""The port's modules against the JAX reference, on the CPU: import hygiene,
the numpy-only copies, Adam, the Backbone-1 model, the group layout and the
int8 uplink codecs. Inputs come from seeded numpy generators."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist as jdist  # noqa: E402
from repro.configs.relief_har import PAMAP2_B1, PAMAP2_B1_SMALL  # noqa: E402
from repro.core import allocation as JAL  # noqa: E402
from repro.core import mdlora as JMD  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.core.engine import plan_allocation as j_plan  # noqa: E402
from repro.core.tasks import MMTask as JTask  # noqa: E402
from repro.data import har as jhar  # noqa: E402
from repro.data import registry as jreg  # noqa: E402
from repro.models import multimodal as JMM  # noqa: E402
from repro.optim import adam_init as j_adam_init  # noqa: E402
from repro.optim import adam_update as j_adam_update  # noqa: E402
from repro.sim import devices as jdev  # noqa: E402
from repro.sim import events as jev  # noqa: E402
from repro_torch import dist as tdist  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import allocation as TAL  # noqa: E402
from repro_torch.core import mdlora as TMD  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core.engine import plan_allocation as t_plan  # noqa: E402
from repro_torch.core.tasks import MMTask as TTask  # noqa: E402
from repro_torch.data import har as thar  # noqa: E402
from repro_torch.data import registry as treg  # noqa: E402
from repro_torch.models import multimodal as TMM  # noqa: E402
from repro_torch.optim import adam_init as t_adam_init  # noqa: E402
from repro_torch.optim import adam_update as t_adam_update  # noqa: E402
from repro_torch.sim import devices as tdev  # noqa: E402
from repro_torch.sim import events as tev  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process, so torch's CPU ops run 2
    threads: with all 8 they contend with it and run ~4x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t_cfg(jcfg):
    """The port's MMConfig with the reference config's fields."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["modalities"] = tuple(TMM.ModalitySpec(m.name, m.channels,
                                                  m.d_feat)
                                 for m in jcfg.modalities)
    return TMM.MMConfig(**fields)


def _j_leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _t_leaves(tree):
    return leaves_with_path(params_to_numpy(tree))


def _assert_same_tree(jtree, ttree, atol=0.0):
    jl, tl = _j_leaves(jtree), _t_leaves(ttree)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        if atol:
            np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=p)
        else:
            np.testing.assert_array_equal(b, a, err_msg=p)


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------


def test_import_pulls_in_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": "src",
                                         "PATH": "/usr/bin:/bin"},
                         cwd=__file__.rsplit("/tests/", 1)[0], timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# numpy-only copies: same seed, same arrays
# ---------------------------------------------------------------------------


def test_har_dataset_and_registry_equal():
    a = jhar.make_har_dataset("pamap2", windows_per_subject=30, seed=3)
    b = thar.make_har_dataset("pamap2", windows_per_subject=30, seed=3)
    for f in ("train_x", "train_y", "test_x", "test_y"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            np.testing.assert_array_equal(x, y)
    a = jreg.get_provider("ucf101_av").build(windows_per_subject=10, seed=1)
    b = treg.get_provider("ucf101_av").build(windows_per_subject=10, seed=1)
    np.testing.assert_array_equal(np.concatenate(a.train_x),
                                  np.concatenate(b.train_x))
    assert jreg.provider_names() == treg.provider_names()
    assert (dataclasses.asdict(jreg.get_provider("pamap2").mm_config(
                "cnn", small=False))
            == dataclasses.asdict(treg.get_provider("pamap2").mm_config(
                "cnn", small=False)))


def test_fleet_timing_and_events_equal():
    for args in ((3, 3, 2), (3, 3, 4)):
        fa = jdev.make_fleet(*args, hetero_scale=100.0)
        fb = tdev.make_fleet(*args, hetero_scale=100.0)
        for f in ("modality_mask", "tops", "active_power", "comm_power",
                  "idle_power", "bandwidth_mbps"):
            np.testing.assert_array_equal(getattr(fa, f), getattr(fb, f))
        assert fa.type_names == fb.type_names
    clients = np.array([0, 3, 7, 5])
    tr, fx, up = RNG.random(4) * 1e9, RNG.random(4) * 1e8, RNG.random(4) * 1e5
    ja = jev.completion_times(fa, clients, tr, fx, up, 1e-3, 2e-5, 0.3,
                              np.random.default_rng(5))
    tb = tev.completion_times(fb, clients, tr, fx, up, 1e-3, 2e-5, 0.3,
                              np.random.default_rng(5))
    for x, y in zip(ja, tb):
        np.testing.assert_array_equal(x, y)
    for Q in (jev.EventQueue, tev.EventQueue):
        q = Q()
        for t, c in ((2.0, 0), (1.0, 1), (1.0, 2), (1.5, 3)):
            q.push(t, client=c)
        assert [e.client for e in q.pop_simultaneous()] == [1, 2]
        assert [e.client for e in q.drain()] == [3, 0]


def test_allocation_and_strategies_equal():
    tau = RNG.random(8) * 1e-2
    n_mand = RNG.integers(1, 4, 8)
    g_max = n_mand + RNG.integers(0, 10, 8)
    ts_j = JAL.solve_t_star(tau, 1e-3, n_mand, g_max)
    assert ts_j == TAL.solve_t_star(tau, 1e-3, n_mand, g_max)
    np.testing.assert_array_equal(
        JAL.elastic_budgets(tau, ts_j, 1e-3, n_mand, g_max),
        TAL.elastic_budgets(tau, ts_j, 1e-3, n_mand, g_max))
    dbar = RNG.random(19)
    acc = RNG.random((8, 19)) < 0.7
    mand = acc & (RNG.random((8, 19)) < 0.2)
    np.testing.assert_array_equal(
        JAL.allocate_topk(dbar, acc, mand, g_max),
        TAL.allocate_topk(dbar, acc, mand, g_max))
    assert JS.names() == TS.names()
    for name in JS.names():
        assert (dataclasses.asdict(JS.get(name))
                == dataclasses.asdict(TS.get(name))), name


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_adam_matches_reference_and_gated_step_is_zero():
    params = {"a": RNG.normal(size=(3, 4)).astype(np.float32),
              "b": {"c": RNG.normal(size=(5,)).astype(np.float32)}}
    jp, js = params, j_adam_init(params)
    tp = params_from_numpy(params, "cpu")
    ts = t_adam_init(tp)
    for step in range(3):
        g = {"a": RNG.normal(size=(3, 4)).astype(np.float32),
             "b": {"c": np.zeros(5, np.float32)}}  # a gated-out group
        jp, js = j_adam_update(jp, g, js, 1e-3)
        tp, ts = t_adam_update(tp, params_from_numpy(g, "cpu"), ts, 1e-3)
        _assert_same_tree(jp, tp, atol=1e-7)
    np.testing.assert_array_equal(tp["b"]["c"].numpy(), params["b"]["c"])


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_model():
    jtask, jtr0 = JTask.create(PAMAP2_B1_SMALL, jax.random.PRNGKey(1))
    ttask, ttr0 = TTask.create(_t_cfg(PAMAP2_B1_SMALL),
                               params=jax.tree.map(np.asarray, jtr0),
                               device="cpu")
    return jtask, jtr0, ttask, ttr0


def test_forward_and_grads_match_reference(small_model):
    """Logits and mm_loss grads at PAMAP2_B1_SMALL, fp32, atol 1e-5; the
    fusion rows of absent modalities get exactly zero gradient."""
    jtask, jtr0, ttask, ttr0 = small_model
    cfg = PAMAP2_B1_SMALL
    x = RNG.normal(size=(6, cfg.window, cfg.total_channels)).astype(np.float32)
    y = RNG.integers(0, cfg.n_classes, 6).astype(np.int32)
    mask = np.array([1, 1, 0, 0], np.float32)  # mag and hr absent

    jl = JMM.mm_forward(jtr0, cfg, jnp.asarray(x), jnp.asarray(mask))
    tl = TMM.mm_forward(ttr0, ttask.cfg, torch.as_tensor(x),
                        torch.as_tensor(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)

    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y),
          "modality_mask": jnp.asarray(mask)}
    tb = {"x": torch.as_tensor(x), "y": torch.as_tensor(y),
          "modality_mask": torch.as_tensor(mask)}
    jg = jax.grad(lambda p: JMM.mm_loss(p, cfg, jb))(jtr0)
    tg = torch.func.grad(lambda p: TMM.mm_loss(p, ttask.cfg, tb))(ttr0)
    _assert_same_tree(jg, tg, atol=1e-5)

    gw = tg["base"]["fusion_w0"].numpy()
    for s, e, g in ttask.layout.fusion_rows:
        absent = mask[ttask.layout.modality[g]] == 0
        assert (gw[s:e] == 0).all() == absent
    for name in ("mag", "hr"):  # absent encoders: exactly zero as well
        for leaf in leaves_with_path(tg["base"]["encoders"][name]):
            assert (leaf[1] == 0).all()


def test_conv_same_padding_is_asymmetric():
    """T=256, k=5, stride 2 pads (1, 2) as XLA's SAME does."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    x = RNG.normal(size=(2, 256, 3)).astype(np.float32)
    w = RNG.normal(size=(5, 3, 4)).astype(np.float32)
    b = RNG.normal(size=(4,)).astype(np.float32)
    for T in (256, 128, 7):
        j = JL.conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                      jnp.asarray(x[:, :T]), stride=2)
        t = TL.conv1d({"w": torch.as_tensor(w), "b": torch.as_tensor(b)},
                      torch.as_tensor(x[:, :T]), stride=2)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


# ---------------------------------------------------------------------------
# group layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jcfg", [PAMAP2_B1_SMALL, PAMAP2_B1],
                         ids=["small", "full"])
def test_group_layout_equal_field_by_field(jcfg):
    jtask, jtr0 = JTask.create(jcfg, jax.random.PRNGKey(0))
    ttask, ttr0 = TTask.create(_t_cfg(jcfg), torch.Generator().manual_seed(0),
                               device="cpu")
    a, b = jtask.layout, ttask.layout
    assert b.G == a.G == (19 if jcfg.M == 4 else a.G)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(y, x, err_msg=f.name)
        elif f.name == "leaf_axis0_groups":
            assert x == {} and y == {}
        else:
            assert y == x, f.name
    # same shapes leaf for leaf, under the same paths
    assert ([(p, x.shape) for p, x in _j_leaves(jtr0)]
            == [(p, x.shape) for p, x in _t_leaves(ttr0)])
    # and the same allocation plan on the paper fleet
    fed = dict(local_epochs=5, steps_per_epoch=4, batch_size=32,
               t_overhead=1e-3, utilization=2e-5)
    from repro.core.engine import FedConfig as JF
    from repro_torch.core.engine import FedConfig as TF
    pj = j_plan(JS.async_relief(), jtask, jdev.make_fleet(3, 3, 2, 4, hetero_scale=100.0),
                JF(**fed), a.flops)
    pt = t_plan(TS.async_relief(), ttask, tdev.make_fleet(3, 3, 2, 4, hetero_scale=100.0),
                TF(**fed), b.flops)
    for f in ("cand", "mandatory", "k"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))


def test_gate_tree_and_group_norms_match(small_model):
    jtask, jtr0, ttask, ttr0 = small_model
    tree = jax.tree.map(lambda x: RNG.normal(size=x.shape).astype(np.float32),
                        jtr0)
    gate = (RNG.random(jtask.layout.G) > 0.4).astype(np.float32)
    jg = JMD.group_gate_tree(jtask.layout, tree, jnp.asarray(gate))
    tt = params_from_numpy(tree, "cpu")
    tg = TMD.group_gate_tree(ttask.layout, tt, torch.as_tensor(gate))
    _assert_same_tree(jg, tg)
    np.testing.assert_allclose(
        TMD.group_norms(ttask.layout, tt).numpy(),
        np.asarray(JMD.group_norms(jtask.layout, tree)), rtol=1e-5)
    # batched gates/norms == per-client reference calls
    K = 3
    stack = jax.tree.map(
        lambda x: RNG.normal(size=(K,) + x.shape).astype(np.float32), jtr0)
    gates = (RNG.random((K, jtask.layout.G)) > 0.4).astype(np.float32)
    tg = TMD.group_gate_tree(ttask.layout, params_from_numpy(stack, "cpu"),
                             torch.as_tensor(gates))
    jg = jax.vmap(lambda t, g: JMD.group_gate_tree(jtask.layout, t, g))(
        stack, jnp.asarray(gates))
    _assert_same_tree(jg, tg)
    np.testing.assert_allclose(
        TMD.group_norms(ttask.layout, tg, batch_dims=1).numpy(),
        np.asarray(jax.vmap(lambda t: JMD.group_norms(jtask.layout, t))(jg)),
        rtol=1e-5)


# ---------------------------------------------------------------------------
# int8 uplink codecs
# ---------------------------------------------------------------------------


def _assert_codes_equal_off_boundary(jq, tq, x, scale):
    """Codes are equal except where x/scale lies within an ulp of a
    rounding boundary (k + 1/2), where the two divisions may round apart;
    there they differ by at most one."""
    jq, tq = np.asarray(jq, np.int32), np.asarray(tq, np.int32)
    diff = jq != tq
    assert (np.abs(jq - tq) <= 1).all()
    ratio = np.asarray(x, np.float32) / np.float32(scale)
    near = np.abs(np.abs(ratio) % 1.0 - 0.5) <= 4 * np.spacing(np.abs(ratio))
    assert not (diff & ~near).any()


def test_int8_codecs_match_reference():
    tree = {"w": (RNG.normal(size=(4, 6, 5)) * 1e-2).astype(np.float32),
            "b": {"c": (RNG.normal(size=(4, 3)) * 1e-3).astype(np.float32)}}
    err = jax.tree.map(lambda x: (RNG.normal(size=x.shape) * 1e-5)
                       .astype(np.float32), tree)
    jq, js, jr = jdist.quantize_int8_stacked(tree, err)
    tq, ts, tr = tdist.quantize_int8_stacked(params_from_numpy(tree, "cpu"),
                                             params_from_numpy(err, "cpu"))
    _assert_same_tree(js, ts)  # max|x|/127 in fp32: exactly equal
    for (_, x), (_, e), (_, s), (_, a), (_, b) in zip(
            _j_leaves(tree), _j_leaves(err), _j_leaves(js), _j_leaves(jq),
            _t_leaves(tq)):
        for k in range(x.shape[0]):  # one scale per client
            _assert_codes_equal_off_boundary(a[k], b[k], (x + e)[k], s[k])
    _assert_same_tree(jr, tr, atol=1e-9)
    _assert_same_tree(jdist.dequantize_int8_stacked(jq, js),
                      tdist.dequantize_int8_stacked(tq, ts), atol=1e-9)
    # per-client codec with error feedback: 0-d scales
    one = jax.tree.map(lambda x: x[0], tree)
    jq1, js1, _ = jdist.quantize_int8_ef(one)
    tq1, ts1, _ = tdist.quantize_int8_ef(params_from_numpy(one, "cpu"))
    _assert_same_tree(js1, ts1)
    for (_, x), (_, s), (_, a), (_, b) in zip(
            _j_leaves(one), _j_leaves(js1), _j_leaves(jq1), _t_leaves(tq1)):
        _assert_codes_equal_off_boundary(a, b, x, s)
