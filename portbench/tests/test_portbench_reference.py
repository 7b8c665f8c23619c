"""The plain references against the port at small sizes on the CPU, and
the controls (the references one precision below) against the limits.

    python -m pytest -q portbench/tests
    python -m pytest -q -m cuda portbench/tests     # on a card
"""
from __future__ import annotations

import pytest
import torch

from _small import HERE, har, harness, limits, lm

inputs = harness.load_module(HERE / "inputs.py", "portbench_inputs")
phi3 = harness.load_module(HERE / "reference" / "phi3.py",
                           "portbench_ref_phi3")
calibrate = harness.load_module(HERE / "calibrate.py", "portbench_calibrate")
HAR, LM = "har-b2-relief-n100", "phi3-engine-adapters"


@pytest.mark.parametrize("seed", [3_000_000_123, 17])
def test_har_reference_follows_the_port(seed):
    ctx, runner = har(seed)
    r = runner.run(ctx)["readings"]
    assert r["alloc_mismatch"] == 0
    for k in ("loss_gap", "dbar_gap", "update1_gap", "change_gap"):
        assert r[k] < 1e-4, (k, r[k])


def test_har_control_reads_far_above_the_port():
    """TF32 products (here the forward operands rounded to TF32) in place
    of the program read at least ten times what the port reads at this
    size; at the cell's size the control fails the limits (the ``cuda``
    test below, and PERF.md)."""
    ctx, runner = har()
    run, data, params, settings, got = runner.drive(ctx)
    recs = runner.reference(ctx, params, data, settings)
    port = runner.readings_of(settings[0], params, got, recs)
    low = runner.reference(ctx, params, data, settings, "tf32")
    ctl = runner.readings_of(settings[0], params,
                             runner.produced_by(low, settings[0]), recs)
    assert ctl["update1_gap"] > 10 * port["update1_gap"], (ctl, port)
    assert ctl["loss_gap"] > 10 * port["loss_gap"], (ctl, port)


def _lm_inputs(m, seed=5):
    base = inputs.normal_leaves(phi3.param_specs(m), seed, "cpu")
    L, r = m["num_hidden_layers"], m["lora_rank"]
    lora = {t: (torch.randn(L, i, r) / i ** 0.5, torch.randn(L, r, o) * 0.3)
            for t, (i, o) in m["lora_targets"].items()}
    return base, lora


def test_phi3_reference_matches_the_port_forward():
    """One request's adapter and fusion mask through the port's forward
    and through the reference, every position's logits, fp32."""
    from repro_torch.models import transformer as TF

    ctx, runner = lm()
    m = ctx.config["model"]
    cfg = runner._port_config(ctx.config)
    base, lora = _lm_inputs(m)
    blocks = torch.tensor([1.0, 0.0])
    mask = phi3.block_mask(m, blocks)
    tokens = torch.randint(0, m["vocab_size"], (1, 12))
    params = inputs.nest(base)
    params["lora"] = {"layers": {t: {"a": a, "b": b}
                                 for t, (a, b) in lora.items()}}
    got, _, _ = TF.lm_forward(params, cfg, tokens, fusion_mask=mask[None])
    want = phi3.logits(m, base, [tokens[0]], [lora], [mask],
                       [torch.arange(12)])[0]
    torch.testing.assert_close(got[0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [3_000_000_123, 17])
def test_engine_serves_what_the_reference_would(seed):
    ctx, runner = lm(seed)
    res = runner.run(ctx)
    assert res["attempted"] > 0
    assert res["readings"]["served_gap"] < 1e-4


def test_phi3_control_reads_far_above_the_engine():
    """fp8 weights in place of the served ones: the gap of the token the
    control puts first is ten times the engine's at this size or more."""
    ctx, runner = lm(control=True)
    r = runner.run(ctx)["readings"]
    assert r["control_gap"] > 10 * max(r["served_gap"], 1e-3), r


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [HAR, LM])
def test_control_fails_at_the_cells_size(workload):
    """The control at the cell's own size on the card (one seed; the
    limits were set from three or more, PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ctx, runner = calibrate.context(workload, 4_000_000_007, 15.0,
                                    torch.device("cuda", 0))
    r = calibrate.readings(ctx, runner, "control")
    if workload == LM:
        assert r["control_gap"] > limits(LM)["served_gap"], r
    else:
        checks = harness.checks(r, limits(HAR))
        assert not all(c["ok"] for c in checks.values()), checks
