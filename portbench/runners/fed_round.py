"""Traffic of kind ``fed_round``: the synchronous federated round, run back
to back.

Set-up builds one ``FedRun`` from the seed's weights, windows and batch
draws, drives its first ``check_rounds`` rounds through ``FedRun.round``
(which also builds and warms every kernel and shape), and hands that same
run to the window. The window runs whole rounds until ``--seconds`` have
passed; none starts after. Evaluation is never run. Without ``--trace`` the
profiler records the card's work over the whole window: the seconds in
which an operation ran on the card, over the rounds completed, are the
cell's end-to-end ``round_device_s``.

Then the plain reference (``reference/har_b2.py``) follows the first
rounds from the same weights, windows and seed, and is compared with what
the program produced there: each round's mean loss, the allocation it
trained under, the divergence EMA, the global update of round 1 by leaf and
the change after the last checked round by leaf.

With ``--trace 1`` the window's rounds run inside spans that the benchmark
puts around the program's local update and server steps, and one round (the
second of the window) under the profiler instead.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import (HERE, Recorder, Spans, device_busy, load_module,
                     profile, say, summary, whole_window)

inputs = load_module(HERE / "inputs.py", "portbench_inputs")
compare = load_module(HERE / "compare.py", "portbench_compare")
ref = load_module(HERE / "reference" / "har_b2.py", "portbench_ref_har_b2")

def _port_config(c: dict):
    from repro_torch.models.multimodal import MMConfig, ModalitySpec
    return MMConfig(
        name=c["name"], modalities=tuple(
            ModalitySpec(m["name"], m["channels"], m["d_feat"])
            for m in c["modalities"]),
        window=c["window"], n_classes=c["n_classes"], backbone="transformer",
        d_fused=c["d_fused"], head_hidden=c["head_hidden"],
        enc_layers=c["enc_layers"], enc_d=c["enc_d"],
        enc_heads=c["enc_heads"], enc_ff=c["enc_ff"], patch=c["patch"],
        lora_rank=c["lora_rank"], lora_alpha=c["lora_alpha"],
        dtype=c["dtype"])


def _k3_call(x, w0, a, b, row_mask, scale=2.0):
    """(K, T, D, F, r, operands shared by all K, bytes per element)."""
    K = x.shape[0] if x.dim() == 3 else None
    shared = [n for n, t, nd in (("w0", w0, 2), ("a", a, 2), ("b", b, 2),
                                 ("mask", row_mask, 1)) if t.dim() == nd]
    return (K, x.shape[-2], x.shape[-1], w0.shape[-1], a.shape[-1], shared,
            x.element_size())


def _flat(tree) -> dict:
    return {k: v.detach().clone() for k, v in inputs.flatten(tree).items()}


def build(ctx):
    """-> (run, data, params, reference settings)."""
    from repro_torch.core import engine as EN
    from repro_torch.core import strategies
    from repro_torch.core.tasks import MMTask
    from repro_torch.sim.devices import FleetConfig

    c, t, dev = ctx.config["model"], ctx.traffic, ctx.device
    b2 = ref.B2.from_config(c)
    data = inputs.har_data(c["modalities"], c["n_classes"], t["clients"],
                           t["windows_per_subject"], ctx.seed)
    f = t["fleet"]
    fl = inputs.fleet(f["tiers"], f["base"], t["clients"], b2.M,
                      f["draw_seed"])
    params = inputs.normal_leaves(ref.param_specs(b2), ctx.seed, dev)
    host = inputs.nest({p: v.cpu().numpy() for p, v in params.items()})
    task, tr0 = MMTask.create(_port_config(c), params=host, device=dev)
    tiers = f["tiers"]
    fleet = FleetConfig(
        fl.modality_mask.copy(), fl.tops.copy(),
        np.array([tiers[i]["active_w"] for i in fl.tier], float),
        np.array([tiers[i]["comm_w"] for i in fl.tier], float),
        np.array([0.2 * tiers[i]["active_w"] for i in fl.tier], float),
        np.array([tiers[i]["uplink_mbps"] for i in fl.tier], float),
        [tiers[i]["name"] for i in fl.tier])
    r = t["round"]
    fed = EN.FedConfig(rounds=10**6, local_epochs=r["local_epochs"],
                       steps_per_epoch=r["steps_per_epoch"],
                       batch_size=r["batch_size"], lr=r["lr"],
                       gamma=r["gamma"], server_lr=r["server_lr"],
                       participation=r["participation"],
                       t_overhead=r["t_overhead"],
                       utilization=r["utilization"], seed=ctx.seed,
                       sim_mode=r["sim_mode"])
    run = EN.FedRun.create(task, tr0, strategies.get(t["strategy"]), fleet,
                           fed)
    return run, data, params, (b2, fl, r)


def drive(ctx):
    """Build the run and drive its first ``check_rounds`` rounds through
    ``FedRun.round`` -> (run, data, params, settings, what the program
    produced there)."""
    from repro_torch.core import engine as EN

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32, as configured
    torch.backends.cudnn.allow_tf32 = False
    run, data, params, settings = build(ctx)
    if ctx.plant is not None:
        ctx.plant(run)
    task = run.task
    got = {"S": [], "loss": [], "dbar": [], "trainable": [],
           "names": list(task.layout.names)}
    # round 1's per-client updates and losses, as the local update returns
    # them to the round
    update = run.local_update

    def first(*a, **kw):
        deltas, losses = update(*a, **kw)
        got["client_deltas"] = _flat(deltas)
        got["client_losses"] = losses.double().cpu().numpy()
        return deltas, losses
    run.local_update = first
    for r in range(ctx.traffic["check_rounds"]):
        if r == 1:
            run.local_update = update
        S, _ = EN.allocate(run.strategy, run.state, task, run.fleet, run.fed,
                           task.layout.flops)
        got["S"].append(np.asarray(S, bool))
        rec = run.round(data)
        got["loss"].append(float(rec["loss"]))
        got["dbar"].append(np.array(run.state.dbar, np.float64))
        got["trainable"].append(_flat(run.state.trainable))
    return run, data, params, settings, got


def reference(ctx, params, data, settings, precision="fp32") -> list:
    b2, fl, rset = settings
    return ref.run_rounds(b2, params, data, fl, rset, ctx.seed,
                          ctx.traffic["check_rounds"], ctx.device, precision)


def produced_by(recs, b2) -> dict:
    """Reference records in the shape of what the program produced (the
    control, the reference one precision below, put in its place)."""
    return {"S": [r.S for r in recs], "loss": [r.loss for r in recs],
            "dbar": [r.dbar for r in recs],
            "trainable": [r.trainable for r in recs],
            "names": ref.groups(b2).names,
            "client_losses": recs[0].client_losses,
            "client_deltas": recs[0].client_deltas}


def run(ctx) -> dict:
    from repro_torch.core import aggregation as AG
    from repro_torch.core import divergence as DV
    from repro_torch.core import engine as EN
    from repro_torch.core import mdlora as MD
    from repro_torch.kernels.mdlora import ops as md_ops

    dev = ctx.device
    run, data, params, settings, got = drive(ctx)
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    # the window
    spans, k3 = Spans(dev), Recorder()
    prof = None
    if ctx.trace:
        run.local_update = spans.wrap("local_update", run.local_update)
        spans.patch(EN, "allocate")
        spans.patch(AG, "aggregate")
        spans.patch(DV, "group_divergence")
        spans.patch(MD, "group_norms")
        md_ops.mdlora_matmul = k3.wrap(md_ops.mdlora_matmul, _k3_call)
    rounds, durations, all_rounds = 0, [], []
    # without --trace the profiler records the card's work over the whole
    # window, for the device seconds per round
    whole = None if ctx.trace or dev.type != "cuda" else whole_window(dev)
    if whole is not None:
        whole.__enter__()
    t_w0 = time.perf_counter()
    deadline = t_w0 + ctx.seconds
    while time.perf_counter() < deadline:
        t_r = time.perf_counter()
        if ctx.trace and rounds == 1:
            k3.on = True
            prof = profile(lambda: run.round(data), dev)
            k3.on = False
        else:
            spans.on = ctx.trace
            run.round(data)
            spans.on = False
            _sync(dev)
            durations.append(time.perf_counter() - t_r)
        all_rounds.append(time.perf_counter() - t_r)
        rounds += 1
    _sync(dev)
    window_s = time.perf_counter() - t_w0
    round_device_s = None
    if whole is not None:
        whole.__exit__(None, None, None)
        round_device_s = device_busy(whole) / rounds
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    say("rounds (s): " + " ".join(f"{t:.3f}" for t in all_rounds))
    say(f"round wall over the window (s): {window_s / rounds!r}")
    if round_device_s is not None:
        say(f"device seconds per round: {round_device_s!r}")

    # free the program, then the reference
    del run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = readings_of(settings[0], params, got,
                           reference(ctx, params, data, settings))
    obs = {"config": ctx.config, "traffic": ctx.traffic,
           "span_total": spans.total, "span_rounds": len(durations),
           "round_s_spanned": float(np.mean(durations)) if durations else None,
           "profile": summary(*prof) if prof else None,
           "profiled_rounds": 1 if prof else 0,
           "k3_calls": k3.calls}
    return {"e2e": {"setup_s": setup_s, "round_device_s": round_device_s},
            "obs": obs, "readings": readings, "attempted": rounds,
            "failed": 0, "peak": peak}


def readings_of(b2, params, got: dict, recs) -> dict:
    """The numbers compared with their limits (PERF.md §2 says why these),
    and by round (``by_round``, not compared) the loss, divergence and
    change gaps."""
    gr = ref.groups(b2)
    perm = [got["names"].index(n) for n in gr.names]  # program id by ref id
    base = {ref.trainable_key(p): params[p] for p in ref.trainable_paths(params)}
    mism = sum(int((S[:, perm] != r.S).any(1).sum())
               for S, r in zip(got["S"], recs))
    loss = [compare.rel_gap(p, r.loss) for p, r in zip(got["loss"], recs)]
    dbar = [compare.vec_gap(d[perm], r.dbar)
            for d, r in zip(got["dbar"], recs)]
    worst = [max(compare.leaf_gaps(t, r.trainable, base))
             for t, r in zip(got["trainable"], recs)]
    rl = recs[0].client_losses
    return {"loss1_gap": float(np.median(np.abs(got["client_losses"] - rl)
                                         / np.abs(rl))),
            "update1_gap": float(np.median(compare.client_gaps(
                got["client_deltas"], recs[0].client_deltas))),
            "loss_gap": max(loss), "alloc_mismatch": float(mism),
            "dbar_gap": max(dbar), "change_gap": worst[-1],
            "by_round": {"loss": loss, "dbar": dbar, "worst_leaf": worst}}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
