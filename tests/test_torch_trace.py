"""The port's tracer (``repro_torch.trace``): nothing recorded outside a
profiler session; the span trees of ``FedRun.round`` and
``ServingEngine.step``; the host side of the clock the profiler's events
carry; the kernels' shared ``reset_launches``; and the benchmark's readers of the spans (``portbench/metrics``). The device side
of the clock is ``test_torch_cuda.py``'s."""
from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import engine as EN
from repro_torch.tree import map_with_path

METRICS = Path(__file__).resolve().parents[1] / "portbench" / "metrics"
ROUND_READERS = ("draw_s.round", "local_issue_s.round", "host_wait_s.round",
                 "round_self_s.round", "useful_share.round")
SERVE_READERS = ("decode_issue_ms.serve", "host_wait_ms.serve",
                 "between_steps_ms.serve")


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(2)
    trace.clear()
    yield
    trace.clear()


def _recording():
    """A CPU-activity profiler session: the trigger the spans record
    under."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "trace_test_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _by_name(recs) -> dict[str, list]:
    out: dict[str, list] = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def _inside(child, parent) -> bool:
    return parent.start <= child.start <= child.end <= parent.end


@pytest.fixture(scope="module")
def relief():
    """A small B2 relief run, one local epoch, no dropout, and its round's
    allocation ([N, G])."""
    from repro_torch.launch import train_relief_har
    torch.set_num_threads(2)
    run, ds = train_relief_har.build(small=True, dropout=0.0, device="cpu")
    run = EN.FedRun.create(run.task, run.proto, run.strategy, run.fleet,
                           dataclasses.replace(run.fed, local_epochs=1))
    S, _ = EN.allocate(run.strategy, run.state, run.task, run.fleet,
                       run.fed, run.task.layout.flops)
    trace.clear()
    with _recording():
        run.round(ds)
    recs = trace.records()
    trace.clear()
    return run, recs, S


@pytest.fixture(scope="module")
def engine_steps():
    """Four steps of the phi3 SMOKE engine, 2 slots, 3 requests: the
    third is admitted once a slot frees up."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import serve
    from repro_torch.launch.serving_engine import ServingEngine
    torch.set_num_threads(2)
    cfg = get_arch("phi3-medium-14b").SMOKE
    params = serve.init_params(cfg, 0, "cpu")
    reg = serve.build_registry(cfg, 2, 0, "cpu")
    eng = ServingEngine(params, cfg, reg, batch_slots=2, max_len=24)
    for r in serve.make_requests(cfg, 3, 2, 6, 3, 2, 0):
        eng.submit(r)
    trace.clear()
    with _recording():
        for _ in range(4):
            eng.step()
    recs = trace.records()
    trace.clear()
    return eng, recs


def test_off_returns_the_shared_noop_and_records_nothing():
    for make in (trace.span, trace.wait):
        cm = make("x", a=1)
        assert cm is trace.OFF
        with cm as inner:
            assert inner is trace.OFF
    assert trace.records() == []


def test_profiler_session_records_nested_spans_and_open_at():
    with _recording():
        with trace.span("outer", rid="r1") as outer:
            with trace.wait("inner") as inner:
                pass
    assert trace.span("after") is trace.OFF
    recs = trace.records()
    assert [r.name for r in recs] == ["outer", "inner"]
    assert (outer.kind, inner.kind) == ("span", "wait")
    assert inner.parent is outer and outer.parent is None
    assert outer.attrs == {"rid": "r1"} and _inside(inner, outer)
    assert inner.path() == "outer > inner"
    assert trace.open_at(inner.start) is inner
    assert trace.open_at(outer.start) is outer
    assert trace.open_at(outer.end) is None


def test_records_past_the_cap_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 2)
    t = trace.Tracer()
    with _recording():
        for _ in range(5):
            with t.span("x"):
                pass
    assert len(t.records()) == 2 and t.dropped == 3


def test_span_under_the_cpu_profiler_holds_its_op_event():
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("mm") as sp:
            x @ x
    assert trace.span("mm") is trace.OFF  # the session has ended
    assert isinstance(sp, trace.Record)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(ev) == 1
    assert sp.start <= ev[0].start_ns() <= ev[0].end_ns() <= sp.end


def test_reset_launches_zeroes_every_launch_count():
    from repro_torch.kernels.cohort_agg import ops as c_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mdlora import ops as md_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    mods = (c_ops, fa_ops, md_ops, ssd_ops)
    counts = [m.LAUNCHES for m in mods] + [fa_ops.PATH_LAUNCHES]
    saved = [dict(d) for d in counts]
    try:
        for d in counts:
            for k in d:
                d[k] += 3
        for m in mods:
            m.reset_launches()
        for d, before in zip(counts, saved):
            assert d == dict.fromkeys(before, 0)  # the same keys, each 0
    finally:
        for d, before in zip(counts, saved):
            d.update(before)


def test_round_span_tree(relief):
    run, recs, _ = relief
    names = _by_name(recs)
    (rnd,) = names["fed.round"]
    assert rnd.parent is None and rnd.attrs == {"round": 1}
    for child in ("fed.allocate", "fed.draw", "fed.local_update",
                  "fed.aggregate", "fed.divergence", "fed.simulate",
                  "loss.to_host"):
        (r,) = names[child]
        assert r.parent is rnd and _inside(r, rnd)
    steps = run.fed.local_epochs * run.fed.steps_per_epoch
    upd = names["fed.local_update"][0]
    assert [r.attrs["step"] for r in names["fed.local_step"]] == list(
        range(steps))
    for st in names["fed.local_step"]:
        assert st.parent is upd and _inside(st, upd)
    for kid in ("local.grad", "local.adam"):
        assert len(names[kid]) == steps
        assert all(r.parent.name == "fed.local_step" and _inside(r, r.parent)
                   for r in names[kid])
    div = names["fed.divergence"][0]
    for w in ("divergence.to_host", "norms.to_host"):
        (r,) = names[w]
        assert r.kind == "wait" and r.parent is div
    assert names["loss.to_host"][0].kind == "wait"
    assert {r.kind for r in recs if r.name.startswith(("fed.", "local."))
            } == {"span"}


def test_local_update_attrs_are_the_allocations_share(relief):
    """``selected``: the selected groups' FLOPs over clients; ``computed``:
    the same over the (client, group) gradients the vmapped step returned,
    today every group of every client."""
    run, recs, S = relief
    names = _by_name(recs)
    (upd,) = names["fed.local_update"]
    flops = run.task.layout.flops
    assert upd.attrs["selected"] == pytest.approx(float((S @ flops).sum()))
    steps = run.fed.local_epochs * run.fed.steps_per_epoch
    assert len(names["local.grad"]) == steps
    for g in names["local.grad"]:
        assert g.attrs["computed"] == pytest.approx(
            float(run.fleet.N * flops.sum()))
    assert 0 < upd.attrs["selected"] < names["local.grad"][0].attrs[
        "computed"]


def test_rows_per_group_reads_the_clients_each_group_holds(relief):
    """From shapes alone: N rows for every group of a stacked tree; a
    group's leaves cut to fewer clients, or left out, read fewer."""
    run, _, _ = relief
    layout, N = run.task.layout, run.fleet.N
    tree = run._start_trainable()
    assert (layout.rows_per_group(tree) == N).all()
    head = [p for p, g in layout.leaf_group.items()
            if layout.names[g].startswith("H_")]
    cut = map_with_path(lambda p, x: x[:2] if p in head else x, tree)
    rows = layout.rows_per_group(cut)
    heads = [layout.leaf_group[p] for p in head]
    assert head and (rows[heads] == 2).all()
    assert (np.delete(rows, heads) == N).all()
    assert (layout.rows_per_group({}) == 0).all()


def test_engine_step_span_tree(engine_steps):
    eng, recs = engine_steps
    names = _by_name(recs)
    assert len(names["engine.step"]) == 4
    assert all(r.parent is None for r in names["engine.step"])
    admits = names["engine.admit"]
    assert [a.attrs["rid"] for a in admits] == ["req-0", "req-1", "req-2"]
    for a in admits:
        assert a.parent.name == "engine.step" and _inside(a, a.parent)
        assert a.attrs["prompt_len"] >= 3
        assert a.attrs["adapter"].startswith("client-")
        kids = [r for r in recs if r.parent is a]
        assert [(k.name, k.kind) for k in kids] == [
            ("admit.prefill", "span"), ("admit.first_token", "wait")]
    decodes = names["engine.decode"]
    # two requests decode in step 1 and finish; the third in step 2; steps
    # 3 and 4 find nothing to do
    assert [d.attrs["rows"] for d in decodes] == [2, 1]
    for d in decodes:
        kids = [r for r in recs if r.parent is d]
        assert [(k.name, k.kind) for k in kids] == [
            ("decode.issue", "span"), ("decode.next_tokens", "wait")]
        assert all(_inside(k, d) for k in kids)
    assert set(eng.latency) == {"req-0", "req-1", "req-2"}
    assert all(v > 0 for v in eng.latency.values())


@pytest.mark.parametrize("name", ROUND_READERS + SERVE_READERS)
def test_readers_without_records_read_nothing(name):
    assert _reader(name)({}) is None


@pytest.mark.parametrize("name", ROUND_READERS)
def test_round_readers_read_a_recorded_round(relief, name):
    run, recs, S = relief
    trace.TRACER._records.extend(recs)
    v = _reader(name)({})
    assert v is not None and math.isfinite(v) and v >= 0
    if name == "useful_share.round":
        flops = run.task.layout.flops
        assert v == pytest.approx(100 * float((S @ flops).sum())
                                  / (run.fleet.N * flops.sum()))
    if name == "draw_s.round":
        assert v == pytest.approx(_by_name(recs)["fed.draw"][0].seconds)


@pytest.mark.parametrize("name", SERVE_READERS)
def test_serve_readers_read_recorded_steps(engine_steps, name):
    _, recs = engine_steps
    trace.TRACER._records.extend(recs)
    v = _reader(name)({})
    assert v is not None and math.isfinite(v) and v >= 0


def test_round_without_tracing_matches_a_traced_round():
    """The spans change nothing the round computes."""
    from repro_torch.launch import train_relief_har
    out = []
    for on in (False, True):
        run, ds = train_relief_har.build(small=True, dropout=0.0,
                                         device="cpu")
        run = EN.FedRun.create(run.task, run.proto, run.strategy, run.fleet,
                               dataclasses.replace(run.fed, local_epochs=1))
        if on:
            with _recording():
                rec = run.round(ds)
            assert trace.records()
        else:
            rec = run.round(ds)
        out.append((rec["loss"], np.asarray(rec["divergence"])))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_idle_time_is_put_down_to_the_innermost_open_span():
    """``profile_serve``'s attribution on a made-up trace: device busy
    [10, 20) and [40, 45) in a window [0, 60); spans a [5, 50) holding
    b [15, 35)."""
    from repro_torch.launch import profile_serve as PS
    gaps = PS._idle_gaps([(40, 45, "k2"), (10, 20, "k1")], 0, 60)
    assert gaps == [(0, 10), (20, 40), (45, 60)]
    with _recording():
        with trace.span("a") as a:
            with trace.span("b") as b:
                pass
    a.start, a.end, b.start, b.end = 5, 50, 15, 35
    got = PS._idle_by_span(gaps, [a, b])
    # idle: [0, 5) none, [5, 10) a, [20, 35) b, [35, 40) a, [45, 50) a,
    # [50, 60) none
    assert got == pytest.approx({"(no span)": 15e-6, "a": 15e-6,
                                 "b": 15e-6})
    assert trace.open_at(25) is b and trace.open_at(37) is a
    assert trace.open_at(55) is None
    # the window's first gap opens before any span: named by where most of
    # it lies
    assert PS._name_gap((0, 12), [a, b]) == (pytest.approx(12e-6),
                                               "(no span)", "a")
    assert PS._name_gap((20, 40), [a, b]) == (pytest.approx(20e-6),
                                               "a > b", "b")


def test_a_profile_without_device_events_raises():
    """A CUDA-only session that recorded nothing on the card (as after a
    CPU-activity session in the same process) must not read as a card idle
    throughout."""
    from repro_torch.launch import profile_serve as PS
    with pytest.raises(RuntimeError, match="no device event"):
        PS._device_breakdown([], 0, 100, 1)
    got = PS._device_breakdown([(10, 20, "k1"), (40, 45, "k2")], 0, 60, 1)
    assert got["busy_ms"] == pytest.approx(15e-6)
    assert got["idle_share"] == pytest.approx(45 / 60)
    assert [k for k, _, _ in got["top"]] == ["k1", "k2"]
    assert got["idle_by_span"] == pytest.approx({"(no span)": 45e-6})
