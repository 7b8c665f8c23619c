"""The port's dropless MoE path (``models/moe.py`` ``impl="dropless"``)
against the benchmark's plain reference (``portbench/reference/mixtral.py``,
loaded by path) and the JAX reference's MoE at a capacity that drops
nothing; a 2-layer fp32 mixtral served by ``ServingEngine`` against the
plain reference's full forward; the MoE spans and their readers
(``portbench/metrics/*.moe.py``), on the CPU.

Tolerances: one layer 1e-5 (fp32 sums over d and f in another order), the
served logits 1e-4 (as the dense models' tests).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMOE
from repro_torch import trace
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serving_engine as TSE
from repro_torch.models import moe as TMOE

BENCH = Path(__file__).resolve().parents[1] / "portbench"
MOE_ATOL, MODEL_ATOL = 1e-5, 1e-4


def _load(path: Path, name: str):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


REF = _load(BENCH / "reference" / "mixtral.py", "portbench_ref_mixtral")
INPUTS = _load(BENCH / "inputs.py", "portbench_inputs")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    trace.clear()
    yield
    trace.clear()
    torch.set_num_threads(n)


def _recording():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def _layer(E=4, d=64, f=96, seed=3):
    g = torch.Generator().manual_seed(seed)
    return TMOE.init_moe_mlp(g, d, f, E, "cpu")


def _plain(p, x, top_k=2):
    """The plain reference's expert layer, one sequence at a time."""
    out = [REF._experts(xb, p["router"], p["wg"], p["wi"], p["wo"], top_k)[0]
           for xb in x]
    return torch.stack(out)


def _x(B, S, d=64, skew=0.0, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, d)) + skew * rng.normal(size=d)
    return torch.from_numpy(x.astype(np.float32))


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skew", [0.0, 1.0], ids=["balanced", "skewed"])
def test_dropless_matches_the_plain_reference(skew):
    """Every token through its top-2 experts: the plain reference's layer
    (each expert over the tokens routed to it) to 1e-5; on the skewed
    router the "sparse" path at capacity 1.25 drops assignments, the
    dropless path none."""
    p, x = _layer(), _x(4, 64, skew=skew)
    got, aux = TMOE.moe_mlp(p, x, top_k=2, impl="dropless")
    torch.testing.assert_close(got, _plain(p, x), atol=MOE_ATOL, rtol=0)
    assert aux == 0.0
    _, _, ids = TMOE.route(p, x, 2)
    cap = TMOE.capacity(64, 2, 4, 1.25)
    _, rank, _ = TMOE.dispatch(ids, 4, cap)
    assert (int((rank >= cap).sum()) > 0) == (skew > 0)
    sparse, _ = TMOE.moe_mlp(p, x, top_k=2)
    assert (sparse - got).abs().max() > 1e-3 if skew else torch.allclose(
        sparse, got, atol=MOE_ATOL)


def test_dropless_matches_the_jax_reference_without_drops():
    """The JAX reference's MoE at capacity factor E (nothing dropped)."""
    E, d, f = 4, 64, 96
    jp = JMOE.init_moe_mlp(jax.random.PRNGKey(3), d, f, E)
    x = _x(3, 40, skew=0.7, seed=8)
    want, _ = JMOE.moe_mlp(jp, jnp.asarray(x.numpy()), top_k=2,
                           capacity_factor=float(E))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got, _ = TMOE.moe_mlp(tp, x, top_k=2, impl="dropless")
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=MOE_ATOL, rtol=0)


def test_reference_follows_the_routes_it_is_given():
    """Given its own router's choice the plain reference computes what it
    computes alone; given one expert a token, that expert's output with
    gate 1; either way it returns its own router's top-2."""
    p, x = _layer(seed=4), _x(1, 30, skew=0.5, seed=6)[0]
    args = (p["router"], p["wg"], p["wi"], p["wo"], 2)
    alone, ids = REF._experts(x, *args)
    forced, own = REF._experts(x, *args, forced=ids)
    torch.testing.assert_close(forced, alone, atol=0, rtol=0)
    one, own1 = REF._experts(x, *args, forced=ids[:, :1])
    assert torch.equal(own, ids) and torch.equal(own1, ids)
    e = ids[:, :1]
    want = torch.stack([
        (torch.nn.functional.silu(x[t] @ p["wg"][i]) * (x[t] @ p["wi"][i]))
        @ p["wo"][i] for t, i in enumerate(e[:, 0].tolist())])
    torch.testing.assert_close(one, want, atol=MOE_ATOL, rtol=0)


def test_decode_dispatch_across_rows_equals_one_row_at_a_time():
    """S = 1 over B rows: the batch-wide dispatch gives each row what it
    gets alone, and the plain reference's."""
    p, x = _layer(seed=11), _x(16, 1, skew=0.5, seed=12)
    got, _ = TMOE.moe_mlp(p, x, top_k=2, impl="dropless")
    rows = torch.cat([TMOE.moe_mlp(p, x[b:b + 1], top_k=2,
                                   impl="dropless")[0] for b in range(16)])
    torch.testing.assert_close(got, rows, atol=MOE_ATOL, rtol=0)
    torch.testing.assert_close(got, _plain(p, x), atol=MOE_ATOL, rtol=0)


@pytest.mark.parametrize("B,S", [(1, 1), (64, 1), (1, 7), (2, 300),
                                 (1, 2048)])
def test_no_assignment_is_dropped_at_any_length(B, S):
    """The ``moe.experts`` span's ``load`` counts every one of the B*S*k
    assignments, at decode and at prompt lengths up to the cell's
    longest, on a skewed router; its ``assignments`` is B*S*k."""
    p, x = _layer(E=8, seed=B + S), _x(B, S, skew=1.5, seed=S)
    with _recording():
        TMOE.moe_mlp(p, x, top_k=2, impl="dropless")
    rec = {r.name: r for r in trace.records()}
    assert set(rec) == {"moe.route", "moe.experts", "moe.combine"}
    attrs = rec["moe.experts"].attrs
    assert attrs["assignments"] == 2 * B * S
    assert attrs["load"].shape == (8,)
    assert int(attrs["load"].sum()) == 2 * B * S


def test_spans_record_nothing_outside_a_profiler():
    p, x = _layer(), _x(2, 5)
    TMOE.moe_mlp(p, x, top_k=2, impl="dropless")
    assert trace.records() == []


# ---------------------------------------------------------------------------
# a 2-layer fp32 mixtral through the serving engine
# ---------------------------------------------------------------------------

MODEL = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 101,
         "rope_theta": 1e6, "rms_norm_eps": 1e-6, "lora_rank": 8,
         "lora_alpha": 16.0,
         "lora_targets": {"wq": [64, 64], "wv": [64, 32], "wo": [64, 64]}}


def _small_mixtral():
    return dataclasses.replace(
        tbase.get_arch("mixtral-8x7b").SMOKE, moe_impl="dropless",
        rope_theta=1e6, layer_pattern="global", sliding_window=None)


@pytest.mark.parametrize("lora_impl", ["xla", "pallas"])
def test_engine_logits_match_the_plain_reference(lora_impl):
    """Ragged prompts over 2 slots, each request with its own adapter and
    fusion mask: the logits of every admission's prefill and of every
    decode row through the per-row cache, against the plain reference's
    full forward over the request's tokens at the same positions."""
    cfg, m = _small_mixtral(), MODEL
    base = INPUTS.normal_leaves(REF.param_specs(m), 21, "cpu")
    L, r = m["num_hidden_layers"], m["lora_rank"]
    g = torch.Generator().manual_seed(22)
    adapters = [{t: (torch.randn(L, i, r, generator=g) / i ** 0.5,
                     torch.randn(L, r, o, generator=g) * 0.3)
                 for t, (i, o) in m["lora_targets"].items()}
                for _ in range(3)]
    blocks = [np.array(b, np.float32) for b in ([1, 1], [1, 0], [0, 1])]
    reg = TSE.AdapterRegistry(cfg, capacity=3, device="cpu")
    for i, (ad, bl) in enumerate(zip(adapters, blocks)):
        reg.register(f"c{i}", {"layers": {t: {"a": a, "b": b}
                                          for t, (a, b) in ad.items()}},
                     modality_mask=bl)
    eng = TSE.ServingEngine(INPUTS.nest(base), cfg, reg, batch_slots=2,
                            max_len=40, lora_impl=lora_impl)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, m["vocab_size"], n) for n in (6, 13, 4, 9)]
    seen = []  # (rid, position, logits)
    at = {}

    def greedy(logits, at=at):
        for row, (rid, pos) in at.items():
            seen.append((rid, pos, logits[row, -1].clone()))
        return logits[:, -1].argmax(-1).to(torch.int32).numpy()

    admit, decode = eng._admit, eng._decode

    def admitting(slot, req):
        at.clear()
        at[0] = (req.rid, len(req.prompt) - 1)
        admit(slot, req)

    def decoding():
        at.clear()
        at.update({s: (eng.requests[s].rid, int(eng.pos[s]))
                   for s in range(eng.B) if eng.active[s]})
        return decode()

    eng._admit, eng._decode = admitting, decoding
    orig = TSE._greedy
    TSE._greedy = greedy
    try:
        for i, (p, n) in enumerate(zip(prompts, (5, 3, 6, 4))):
            eng.submit(TSE.Request(rid=f"r{i}", prompt=p, adapter=f"c{i % 3}",
                                   max_new_tokens=n))
        out = eng.run()["outputs"]
    finally:
        TSE._greedy = orig
    rids = [f"r{i}" for i in range(4)]
    seqs = [torch.as_tensor(np.concatenate([prompts[i], out[rid][:-1]]))
            for i, rid in enumerate(rids)]
    want, _ = REF.forward(
        m, base, seqs,
        [adapters[i % 3] for i in range(4)],
        [REF.block_mask(m, torch.as_tensor(blocks[i % 3])) for i in range(4)],
        [torch.arange(len(s)) for s in seqs])
    assert len(seen) == sum(len(out[rid]) for rid in rids)
    for rid, pos, lg in seen:
        torch.testing.assert_close(lg, want[rids.index(rid)][pos],
                                   atol=MODEL_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the benchmark's readers of the MoE spans
# ---------------------------------------------------------------------------


@pytest.fixture
def runner(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))
    monkeypatch.syspath_prepend(str(BENCH / "metrics"))
    return _load(BENCH / "runners" / "engine_loop_moe.py",
                 "portbench_runner_engine_loop_moe")


def _reader(name: str):
    return _load(BENCH / "metrics" / f"{name}.py",
                 "trace_test_" + name.replace(".", "_")).read


class _Ev:
    def __init__(self, name, corr, s, e, cuda):
        self._v = (name, corr, s, e, cuda)

    def name(self):
        return self._v[0]

    def correlation_id(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[4] else DeviceType.CPU


def test_kernels_are_put_down_to_the_moe_span_that_launched_them(runner):
    """A kernel belongs to the MoE span open when its launch call started
    (matched by correlation id), wherever it ran on the card; the product
    kernels of each ``moe.experts`` call are counted apart; the readers
    read the shares and the load."""
    p, x = _layer(E=4, seed=1), _x(2, 8)
    with _recording():
        TMOE.moe_mlp(p, x, top_k=2, impl="dropless")
    rec = {r.name: r for r in trace.records()}
    ro, ex, co = rec["moe.route"], rec["moe.experts"], rec["moe.combine"]
    evs = [_Ev("cudaLaunchKernel", 1, ro.start + 1, ro.start + 2, False),
           _Ev("softmax_kernel", 1, co.end + 10, co.end + 1010, True),
           _Ev("cudaLaunchKernel", 2, ex.start + 1, ex.start + 2, False),
           _Ev("radixSortKVInPlace", 2, co.end + 2000, co.end + 2500, True),
           _Ev("cudaLaunchKernelExC", 3, ex.end - 1, ex.end, False),
           _Ev("cutlass_GemmUniversal_GroupProblemShape", 3, co.end + 3000,
               co.end + 7000, True),
           _Ev("cudaLaunchKernel", 4, co.start + 1, co.start + 2, False),
           _Ev("index_copy_kernel", 4, co.end + 8000, co.end + 9000, True),
           _Ev("cudaLaunchKernel", 5, co.end + 5, co.end + 6, False),
           _Ev("after_the_layer", 5, co.end + 9000, co.end + 19000, True)]
    prof = type("P", (), {})()
    prof.profiler = type("A", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda s: evs})()
    got = runner.moe_breakdown(prof)
    assert got["span_s"] == pytest.approx(
        {"moe.route": 1e-6, "moe.experts": 4.5e-6, "moe.combine": 1e-6})
    (a, load, prod), = got["calls"]
    assert a == 32 and sum(load) == 32 and prod == pytest.approx(4e-6)
    obs = {"config": {"model": {"hidden_size": 64,
                                "intermediate_size": 96}},
           "profile": {"busy_s": 11e-6, "window_s": 20e-6, "moe": got}}
    assert _reader("experts_share.moe")(obs) == pytest.approx(
        100 * 5.5 / 11)
    assert _reader("expert_load.moe")(obs) == pytest.approx(
        max(load) * 4 / 32)
    R = _load(BENCH / "metrics" / "_moe_roofline.py", "_moe_roofline")
    assert _reader("experts_roofline_share.moe")(obs) == pytest.approx(
        100 * R.experts_bound_s(64, 96, 32, load) / 4e-6)


@pytest.mark.parametrize("name", ["experts_share.moe",
                                  "experts_roofline_share.moe",
                                  "expert_load.moe", "decode_step_ms.moe",
                                  "device_idle_share.moe",
                                  "k4_roofline_share.moe"])
def test_moe_readers_without_records_read_nothing(runner, name):
    """A run without MoE spans (a program that has none) reads nothing."""
    assert _reader(name)({"profile": None, "config": {"model": MODEL}}) \
        is None


def test_roofline_counts_the_experts_that_got_a_row():
    R = _load(BENCH / "metrics" / "_moe_roofline.py", "_moe_roofline")
    d, f = 4096, 14336
    # a decode step: 128 rows, every expert read once, bound by bytes
    b = R.experts_bytes(d, f, 128, [16] * 8)
    assert b == 2 * (3 * 8 * d * f + 3 * 128 * (d + f))
    assert R.experts_bound_s(d, f, 128, [16] * 8) == pytest.approx(
        b / 3.35e12)
    assert R.experts_bytes(d, f, 128, [64, 64, 0, 0, 0, 0, 0, 0]) < b
    # an admission of 2048 tokens: bound by operations
    assert R.experts_bound_s(d, f, 4096, [512] * 8) == pytest.approx(
        6 * 4096 * d * f / 989e12)
