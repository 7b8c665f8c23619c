"""The MoE serving cell at a small size on the CPU: the engine serves what
the plain reference would, the control reads far above it, each planted
fault of the expert layer, the cache or the tokens is not ``correct``, and
a program without the dropless path fails before drawing anything.

    python -m pytest -q portbench/tests
"""
from __future__ import annotations

import pytest

from _small import HERE, harness, limits
from _small_moe import moe

calibrate_moe = harness.load_module(HERE / "calibrate_moe.py",
                                    "portbench_calibrate_moe")
MOE = "mixtral-engine-adapters"


@pytest.fixture
def fresh_moe():
    """Plants patch the program's MoE module: put it back after each."""
    from repro_torch.models import moe as M
    saved = M.route, M._dropless
    yield
    M.route, M._dropless = saved


@pytest.mark.parametrize("seed", [3_000_000_123, 17])
def test_engine_serves_what_the_reference_would(seed):
    ctx, runner = moe(seed)
    res = runner.run(ctx)
    assert res["attempted"] > 0
    assert res["readings"]["served_gap"] < 1e-4
    assert res["readings"]["route_mismatch"] == 0.0


def test_control_reads_far_above_the_engine():
    ctx, runner = moe(control=True)
    r = runner.run(ctx)["readings"]
    assert r["control_gap"] > 10 * max(r["served_gap"], 1e-3), r
    assert r["control_route_mismatch"] > 0, r


@pytest.mark.parametrize("fault", ["token", "stale", "drops", "top1",
                                   "unnormalised"])
def test_a_fault_is_not_correct(fresh_moe, fault):
    plant = {"token": calibrate_moe.calibrate.alter_tokens,
             "stale": calibrate_moe.calibrate.stale_cache,
             "top1": calibrate_moe.top1}.get(fault)
    {"drops": calibrate_moe.plant_drops,
     "unnormalised": calibrate_moe.plant_unnormalised}.get(
        fault, lambda: None)()
    ctx, runner = moe(plant=plant)
    checks = harness.checks(runner.run(ctx)["readings"], limits(MOE))
    assert not all(c["ok"] for c in checks.values()), checks


def test_a_program_without_the_dropless_path_fails_first(fresh_moe,
                                                         monkeypatch):
    from repro_torch.models import moe as M
    mlp = M.moe_mlp

    def parent(p, x, *, impl="sparse", **kw):
        if impl == "dropless":
            raise ValueError(f"unknown moe impl {impl!r}")
        return mlp(p, x, impl=impl, **kw)
    monkeypatch.setattr(M, "moe_mlp", parent)
    ctx, runner = moe()
    monkeypatch.setattr(runner.el, "build", None)  # nothing may be drawn
    with pytest.raises(RuntimeError, match="no dropless MoE path"):
        runner.run(ctx)


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    """The control at the cell's own size on the card (one seed; the
    limits were set from three or more, PERF.md): it fails both limits."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ctx, runner = calibrate_moe.calibrate.context(
        MOE, 4_000_000_031, 10.0, torch.device("cuda", 0))
    r = calibrate_moe.calibrate.readings(ctx, runner, "control")
    assert r["control_gap"] > limits(MOE)["served_gap"], r
    assert r["control_route_mismatch"] > limits(MOE)["route_mismatch"], r
