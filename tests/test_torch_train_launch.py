"""The port's training launcher (``launch/train.py``) and LoRA fine-tune
example (``launch/lora_finetune_backbone.py``) on the CPU: the backbone
mode's checkpoint/resume, its federated mode against the reference's
``train_federated``, and the example's falling loss.

The federated mode is held as ``tests/test_torch_sync.py`` holds FedRun:
the same participants, simulated time and upload exactly (rel 1e-12),
losses and the divergence at rtol 1e-5, F1 to 1e-6.
"""
import argparse
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core.tasks import MMTask as JTask  # noqa: E402
from repro.data import mm_config_for as j_mm_config_for  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adam_init as j_adam_init  # noqa: E402
from repro_torch.launch import lora_finetune_backbone, train  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process: torch runs 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _smoke(ckpt_dir, steps, *extra):
    return ["--smoke", "--device", "cpu", "--steps", str(steps),
            "--ckpt-every", "3", "--ckpt-dir", str(ckpt_dir), *extra]


def test_backbone_resume_repeats_the_uninterrupted_run(tmp_path):
    """phi3-medium-14b SMOKE, LoRA, the reference's B=8, S=128: 6 steps at
    once, against 3 steps, a checkpoint, and a second run that resumes at
    step 3 from it: the last 3 losses and the step-6 checkpoints bitwise
    equal. The checkpoint holds the reference's tree ({"params", "opt"},
    Adam's step an int32 leaf), which the reference restores."""
    whole = train.main(_smoke(tmp_path / "a", 6))
    train.main(_smoke(tmp_path / "b", 3))
    resumed = train.main(_smoke(tmp_path / "b", 6))
    assert len(whole["loss"]) == 6 and len(resumed["loss"]) == 3
    assert resumed["loss"] == whole["loss"][3:]
    assert all(np.isfinite(whole["loss"]))
    assert sorted(os.listdir(tmp_path / "b")) == ["step_00000003",
                                                  "step_00000006"]
    arrays = [np.load(tmp_path / d / "step_00000006" / "arrays.npz")
              for d in "ab"]
    assert arrays[0].files == arrays[1].files
    for k in arrays[0].files:
        np.testing.assert_array_equal(arrays[0][k], arrays[1][k])
    with open(tmp_path / "a" / "step_00000006" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["metadata"] == {"arch": "phi3-medium-14b", "step": 6}
    i = manifest["paths"].index("['opt']['t']")
    assert manifest["dtypes"][i] == "int32" and manifest["shapes"][i] == []
    jparams = japi.init_model(jax.random.PRNGKey(0),
                              jbase.get_arch("phi3-medium-14b").SMOKE)
    like = {"params": jparams, "opt": j_adam_init(jparams["lora"])}
    assert [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(like)[0]] == \
        manifest["paths"]
    state, meta = JCkpt(str(tmp_path / "a")).restore(6, like)
    assert int(state["opt"]["t"]) == 6 and meta["step"] == 6


@pytest.mark.parametrize("arch,mode", [("musicgen-large", "lora"),
                                       ("llava-next-34b", "lora"),
                                       ("mamba2-1.3b", "full")])
def test_backbone_other_families_train(tmp_path, arch, mode):
    """The codebook stream, llava's zero patches and full-parameter
    training through the launcher: finite losses."""
    hist = train.main(_smoke(tmp_path, 2, "--arch", arch, "--train-mode",
                             mode, "--batch", "2", "--seq", "32"))
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))


def test_model_parallel_raises(tmp_path):
    with pytest.raises(ValueError, match="sharding.py"):
        train.main(_smoke(tmp_path, 1, "--model-parallel", "2"))


FED = ["--mode", "federated", "--backbone", "b2", "--rounds", "2",
       "--windows", "40", "--eval-every", "5", "--device", "cpu"]


def test_federated_mode_holds_the_reference():
    """``--mode federated`` on Backbone 2 (the reference's
    ``mm_config_for`` model of it: the fusion layer at full width, D 112 ->
    128, r 8; a 2 x 64 encoder), 2 rounds, 40 windows per subject: the
    history of the reference's ``train_federated`` from the same weights."""
    args = train.parse_args(FED)
    jhist = jtrain.train_federated(argparse.Namespace(**{
        k: v for k, v in vars(args).items() if k != "device"}))
    cfg = j_mm_config_for("pamap2", backbone="transformer")
    jtask, jtr0 = JTask.create(cfg, jax.random.PRNGKey(args.seed))
    run, ds = train.federated_run(
        args, params=jax.tree.map(np.asarray, jtask.params(jtr0)))
    thist = run.run(ds, log_every=args.eval_every)
    assert thist["round"] == jhist["round"] == [1, 2]
    for key in ("round_time_s", "energy_j", "upload_mb", "selected_frac"):
        np.testing.assert_allclose(thist[key], jhist[key], rtol=1e-12,
                                   err_msg=key)
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=1e-5)
    np.testing.assert_allclose(thist["divergence"], jhist["divergence"],
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(thist["f1"], jhist["f1"], atol=1e-6)
    assert thist["f1_round"] == jhist["f1_round"] == [2]


def test_lora_finetune_backbone_loss_falls(tmp_path):
    """The example's defaults (gemma2-27b SMOKE, 30 steps, lr 3e-3): the
    loss falls (the script raises otherwise) and the LoRA tree is saved
    every 10 steps, the newest kept."""
    losses = lora_finetune_backbone.main(["--device", "cpu", "--ckpt-dir",
                                          str(tmp_path)])
    assert len(losses) == 30 and losses[-1] < losses[0]
    assert os.listdir(tmp_path) == ["step_00000030"]
    with open(tmp_path / "step_00000030" / "manifest.json") as f:
        paths = json.load(f)["paths"]
    assert paths and all(p.startswith("['lora']['layers']") for p in paths)
