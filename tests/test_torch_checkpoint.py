"""The port's checkpoints (``repro_torch.checkpoint``) and the sync
driver's save and resume (``launch/train_relief_har.py``) against the JAX
reference's (``repro.checkpoint``, ``examples/train_relief_har.py``), on
the CPU.

The on-disk layout is the reference's, so each package restores what the
other wrote, bit for bit (bfloat16 included). One deliberate difference:
the port's ``steps()`` ignores a temp directory left between a save's
manifest and its rename, where the reference raises."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JCM  # noqa: E402
from repro.checkpoint import restore_tree as j_restore  # noqa: E402
from repro.checkpoint import save_tree as j_save  # noqa: E402
from repro.configs import relief_har as JC  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.core.tasks import MMTask as JTask  # noqa: E402
from repro.data import make_har_dataset as j_dataset  # noqa: E402
from repro.sim import make_fleet as j_fleet  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import restore_tree, save_tree  # noqa: E402
from repro_torch.configs import relief_har as TC  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core.tasks import MMTask as TTask  # noqa: E402
from repro_torch.data import make_har_dataset as t_dataset  # noqa: E402
from repro_torch.launch import train_relief_har  # noqa: E402
from repro_torch.sim import make_fleet as t_fleet  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path, tree_map  # noqa: E402

# a resumed run's losses are fp32 sums in another order than the
# reference's; its trainable moves by the same rounding over 4 rounds
LOSS_RTOL, TREE_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process, so torch's CPU ops run 2
    threads: with all 8 they contend with it and run ~4x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the reference's checkpoint tests (tests/test_substrate.py:57-118), ported
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16)}}
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    mgr.save(1, tree, {"round": 1})
    mgr.save(2, tree_map(lambda x: x * 2, tree), {"round": 2})
    restored, meta = mgr.restore_latest(tree)
    assert meta["round"] == 2 and meta["step"] == 2
    np.testing.assert_allclose(restored["a"].numpy(), np.arange(5) * 2)
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"] * 2)


def test_checkpoint_retention_and_resume(tmp_path):
    tree = {"w": torch.zeros(3)}
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    for s in range(5):
        mgr.save(s, tree_map(lambda x, s=s: x + s, tree))
    assert mgr.steps() == [3, 4]  # retention
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    assert mgr2.latest_step() == 4  # resume across a process restart
    restored, _ = mgr2.restore_latest(tree)
    assert torch.equal(restored["w"], torch.full((3,), 4.0))


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    save_tree(str(tmp_path / "x"), {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_tree(str(tmp_path / "x"), {"a": torch.ones(3),
                                           "b": torch.ones(2)})


def test_engine_state_checkpoint_roundtrip(tmp_path):
    """The FL server state survives a simulated preemption."""
    from repro_torch.data.har import mm_config_for

    ds = t_dataset("pamap2", windows_per_subject=40, seed=0)
    cfg = mm_config_for("pamap2", backbone="cnn", d_feat=8, d_fused=32,
                        cnn_ch=(8, 16))
    task, tr0 = TTask.create(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    fed = TE.FedConfig(rounds=2, local_epochs=1, steps_per_epoch=1,
                       batch_size=8, eval_every=2)
    run = TE.FedRun.create(task, tr0, TS.get_strategy("relief"),
                           t_fleet(2, 1, 1, M=4), fed)
    run.round(ds)
    mgr = CheckpointManager(str(tmp_path / "fed"), keep=1)
    mgr.save(run.state.round, {"trainable": run.state.trainable},
             {"dbar": run.state.dbar.tolist(), "round": run.state.round})
    restored, meta = mgr.restore_latest({"trainable": run.state.trainable})
    assert meta["round"] == 1
    np.testing.assert_array_equal(np.asarray(meta["dbar"], np.float32),
                                  run.state.dbar)
    for a, b in zip(leaves(restored["trainable"]),
                    leaves(run.state.trainable), strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _values():
    """fp32, bf16, int and bool leaves under nested keys, as numpy."""
    g = np.random.default_rng(3)
    return {
        "enc": {"w": g.normal(size=(3, 4)).astype(np.float32),
                "b": g.normal(size=(5,)).astype(ml_dtypes.bfloat16)},
        "steps": np.array([7, -2], np.int32),
        "count": np.array(11, np.int32),
        "z": {"deep": {"k": g.normal(size=(2, 2, 2)).astype(np.float32),
                       "on": np.array([True, False])}},
    }


def _j_tree(values):
    return jax.tree.map(jnp.asarray, values)


def _t_tree(values):
    def to_t(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(to_t, values)


def _bits(a) -> np.ndarray:
    """A leaf of either package as its raw host words."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_between_packages_bitwise(tmp_path, writer):
    """A checkpoint written by either package restores into the other bit
    for bit (bf16 included), and both write the same manifest (paths,
    dtypes, shapes, metadata) and the same ``arrays.npz`` entries."""
    values = _values()
    jtree, ttree = _j_tree(values), _t_tree(values)
    meta = {"round": 3, "dbar": [0.25, 1e-6]}
    j_save(str(tmp_path / "j"), jtree, meta)
    save_tree(str(tmp_path / "t"), ttree, meta)
    jm, tm = _manifest(tmp_path / "j"), _manifest(tmp_path / "t")
    assert tm == jm
    assert "bfloat16" in tm["dtypes"] and "['enc']['b']" in tm["paths"]
    with np.load(tmp_path / "j" / "arrays.npz") as a, \
            np.load(tmp_path / "t" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    if writer == "reference":  # the port restores the reference's files
        zeros = tree_map(torch.zeros_like, ttree)
        got, got_meta = restore_tree(str(tmp_path / "j"), zeros)
        pairs = zip(leaves(got), leaves(ttree), strict=True)
    else:  # the reference restores the port's files
        zeros = jax.tree.map(jnp.zeros_like, jtree)
        got, got_meta = j_restore(str(tmp_path / "t"), zeros)
        pairs = zip(jax.tree.leaves(got), jax.tree.leaves(jtree), strict=True)
    assert got_meta == meta
    for a, b in pairs:
        assert _bits(a).dtype == _bits(b).dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_leftover_temp_directory_is_ignored(tmp_path):
    """A crash between a save's manifest and its rename leaves
    ``step_<n>.tmp.<pid>.<us>/`` holding a manifest. The port's ``steps()``
    ignores it; the reference's parses its name and raises."""
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(3, dtype=torch.float32)}
    mgr = CheckpointManager(d, keep=3)
    mgr.save(2, tree)
    tmp = os.path.join(d, "step_00000003.tmp.123.456")
    os.makedirs(tmp)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({}, f)
    assert mgr.steps() == [2] and mgr.latest_step() == 2
    restored, meta = mgr.restore_latest(tree)
    assert meta["step"] == 2 and torch.equal(restored["w"], tree["w"])
    with pytest.raises(ValueError, match="invalid literal"):
        JCM(d).steps()


# ---------------------------------------------------------------------------
# the sync run's save and resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def b2():
    """PAMAP2_B2_SMALL: the reference's task and weights, the port's task
    from the same weights, and the same data for both."""
    jtask, jtr0 = JTask.create(JC.PAMAP2_B2_SMALL, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtask.params(jtr0))
    ttask, ttr0 = TTask.create(TC.PAMAP2_B2_SMALL, params=params,
                               device="cpu")
    return (jtask, jtr0, j_dataset("pamap2", windows_per_subject=60, seed=0),
            ttask, ttr0, t_dataset("pamap2", windows_per_subject=60, seed=0))


def _fed(E):
    """``train_relief_har``'s FedConfig (the reference example's), 4 rounds."""
    return E.FedConfig(rounds=4, eval_every=10, seed=0, utilization=2e-5,
                       dropout_prob=0.1)


def _reference_resumed(jtask, jtr0, jds, ckdir):
    """The reference example's loop (examples/train_relief_har.py:68-87):
    2 rounds with a save at round 2, then a fresh run resumed from that
    checkpoint for rounds 3-4 -> (losses before, losses after, run)."""
    def fresh():
        return JE.FedRun.create(jtask, jtr0, JS.get("relief"),
                                j_fleet(3, 3, 2, M=4), _fed(JE))
    ckpt = JCM(ckdir, keep=2)
    run = fresh()
    before = [run.round(jds)["loss"] for _ in range(2)]
    ckpt.save(2, {"trainable": run.state.trainable},
              {"dbar": run.state.dbar.tolist(), "strategy": "relief"})
    run = fresh()
    state, meta = ckpt.restore_latest({"trainable": run.state.trainable})
    run.state.trainable = state["trainable"]
    run.state.dbar = np.asarray(meta["dbar"])
    after = [run.round(jds)["loss"] for _ in range(meta["step"], 4)]
    return before, after, run


def test_fedrun_save_and_resume_match_reference(b2, tmp_path):
    """PAMAP2_B2_SMALL, paper fleet, 10% dropout: 2 rounds and a save,
    then a fresh run resumed for 2 more, in both packages. The resumed run
    restores the trainable tree and dbar only (round index, rng, mag_ema
    and history start fresh), so it is held against the reference's
    resumed run, not against an uninterrupted one."""
    jtask, jtr0, jds, ttask, ttr0, tds = b2
    jb, ja, jrun = _reference_resumed(jtask, jtr0, jds, str(tmp_path / "j"))

    def fresh():
        return TE.FedRun.create(ttask, ttr0, TS.get("relief"),
                                t_fleet(3, 3, 2, M=4), _fed(TE))
    ckpt = CheckpointManager(str(tmp_path / "t"), keep=2)
    run = fresh()
    hb = train_relief_har.train(run, tds, 2, ckpt=ckpt, ckpt_every=2)
    saved = {p: t.clone() for p, t in leaves_with_path(run.state.trainable)}
    saved_dbar = run.state.dbar.copy()
    assert ckpt.steps() == [2]
    run = fresh()
    start = train_relief_har.resume(run, ckpt)
    assert start == 2 and np.array_equal(run.state.dbar, saved_dbar)
    for p, t in leaves_with_path(run.state.trainable):
        assert torch.equal(t, saved[p]), p
    ha = train_relief_har.train(run, tds, 4, start, ckpt, 2)

    np.testing.assert_allclose(hb["loss"], jb, rtol=LOSS_RTOL)
    np.testing.assert_allclose(ha["loss"], ja, rtol=LOSS_RTOL)
    assert ha["round"] == [1, 2] and ckpt.steps() == [2, 4]
    np.testing.assert_allclose(run.state.dbar, jrun.state.dbar, rtol=1e-4,
                               atol=1e-9)
    jl = jax.tree_util.tree_flatten_with_path(jrun.state.trainable)[0]
    tl = leaves_with_path(params_to_numpy(run.state.trainable))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl, strict=True):
        np.testing.assert_allclose(b, np.asarray(a), atol=TREE_ATOL,
                                   err_msg=jax.tree_util.keystr(p))
    # the reference restores the port's last checkpoint bit for bit
    got, meta = JCM(str(tmp_path / "t")).restore_latest(
        {"trainable": jrun.state.trainable})
    assert meta["step"] == 4 and meta["strategy"] == "relief"
    for a, (_, b) in zip(jax.tree.leaves(got["trainable"]), tl, strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_cli_saves_and_resumes_on_cpu(tmp_path, capsys):
    """``train_relief_har --device cpu --small --ckpt-dir``: 2 rounds with
    a save at round 2, then a rerun with ``--rounds 3`` resumes there."""
    d = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--small", "--ckpt-dir", d, "--ckpt-every",
            "2"]
    first = train_relief_har.main(argv + ["--rounds", "2"])
    assert first["round"] == [1, 2] and CheckpointManager(d).steps() == [2]
    assert "resumed" not in capsys.readouterr().out
    again = train_relief_har.main(argv + ["--rounds", "3"])
    out = capsys.readouterr().out
    assert f"resumed from round 2 ({d})" in out
    assert again["round"] == [1] and np.isfinite(again["loss"]).all()
    assert 0.0 <= again["f1"][-1] <= 1.0
