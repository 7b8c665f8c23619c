"""Traffic of kind ``engine_loop``: ``ServingEngine`` under an open loop of
requests, each with its own modality-block adapter.

Set-up draws the served model's weights and the adapters on the device
from the seed, registers the adapters with their modality masks, builds
the engine, and sends the pool's first ``warm_requests`` at once; the
engine then runs ``warm_steps`` steps (those admissions, the kernels'
builds). From the window's start the other requests arrive at fixed times,
whatever the engine has finished, at ``arrival.rate_per_s``; the window
runs ``ServingEngine.step`` back to back until ``--seconds`` have passed. A
request is submitted at the first step boundary at or after it is due, and
its latency counts from when it was due.

Requests come from a pool drawn from the seed: prompt and output lengths
at the quantiles of their log-uniform ranges and the gaps between arrivals
at the exponential's, each reshuffled in every block of ``strata``
requests, so every seed serves the same lengths and gaps in its own order;
adapters Zipf over the registered ones; prompt tokens uniform.

After the window the plain reference (``reference/phi3.py``) reads, for a
sample of finished requests drawn from the seed with the longest among
them, the logits at every position that produced a served token, and the
widest gap by which a served token's logit lies below the best.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from harness import HERE, Recorder, Spans, load_module, profile, summary

inputs = load_module(HERE / "inputs.py", "portbench_inputs")
ref = load_module(HERE / "reference" / "phi3.py", "portbench_ref_phi3")

def _port_config(c: dict):
    from repro_torch.configs.base import get_arch
    p, m = c["port"], c["model"]
    cfg = dataclasses.replace(getattr(get_arch(p["arch"]), p["preset"]),
                              **p.get("overrides", {}))
    same = {"d_model": "hidden_size", "n_layers": "num_hidden_layers",
            "n_heads": "num_attention_heads",
            "n_kv_heads": "num_key_value_heads", "head_dim": "head_dim",
            "d_ff": "intermediate_size", "vocab": "vocab_size",
            "rope_theta": "rope_theta", "lora_rank": "lora_rank",
            "lora_alpha": "lora_alpha"}
    for ours, theirs in same.items():
        if getattr(cfg, ours) != m[theirs]:
            raise ValueError(f"the port's {ours} = {getattr(cfg, ours)} is "
                             f"not the configuration's {theirs} = {m[theirs]}")
    return cfg


def _k4_describer(engine):
    """-> describe(call) = (B, D, F, r, adapters read, masked, bytes per
    element of x); the adapters read are the engine's row slots, on the
    host, so that recording adds no device work."""
    def describe(x, w0, a, b, adapter_idx, row_mask=None, scale=2.0,
                 plan=None):
        return (x.shape[0], x.shape[1], w0.shape[1], a.shape[-1],
                len(np.unique(engine.adapter_idx)), row_mask is not None,
                x.element_size())
    return describe


def _strata(rng, q: np.ndarray, n: int) -> np.ndarray:
    """n values: the quantiles ``q``, reshuffled in every block."""
    return np.concatenate([rng.permutation(q)
                           for _ in range(-(-n // len(q)))])[:n]


def _pool(t: dict, seed: int, vocab: int, n_adapters: int) -> list[tuple]:
    """[(prompt tokens, output length, adapter)] from the seed."""
    rng = np.random.default_rng(seed)
    n, k = t["pool"], t["strata"]
    lens_p = _strata(rng, inputs.log_uniform_pool(
        t["prompt"]["lo"], t["prompt"]["hi"], k), n)
    lens_o = _strata(rng, inputs.log_uniform_pool(
        t["output"]["lo"], t["output"]["hi"], k), n)
    ad = rng.choice(n_adapters, size=n,
                    p=inputs.zipf_probs(n_adapters, t["zipf_s"]))
    return [(rng.integers(0, vocab, size=int(p)).astype(np.int32), int(o),
             int(a)) for p, o, a in zip(lens_p, lens_o, ad)]


def _due(t: dict, seed: int) -> np.ndarray:
    """Arrival offsets (s) from the window's start of the requests after
    the warm ones: gaps at the exponential's quantiles for the rate."""
    k = t["strata"]
    q = -np.log1p(-(np.arange(k) + 0.5) / k) / t["arrival"]["rate_per_s"]
    return np.cumsum(_strata(np.random.default_rng([seed, 3]), q,
                             t["pool"] - t["warm_requests"]))


def _adapter_masks(t: dict, m: dict, seed: int) -> np.ndarray:
    """[A, n_kv_heads] 0/1: each adapter's tier drawn from the seed by the
    tiers' shares; a tier holds the first ceil(share x blocks) blocks."""
    K, A = m["num_key_value_heads"], t["adapters"]
    rng = np.random.default_rng([seed, 1])
    shares = np.array([tr["share"] for tr in t["tiers"]], float)
    tier = rng.choice(len(shares), size=A, p=shares / shares.sum())
    out = np.zeros((A, K), np.float32)
    for i, ti in enumerate(tier):
        out[i, :math.ceil(t["tiers"][ti]["blocks"] * K)] = 1.0
    return out


def build(ctx):
    from repro_torch.launch.serving_engine import AdapterRegistry, ServingEngine

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    m = c["model"]
    cfg = _port_config(c)
    dt = getattr(torch, m["torch_dtype"])
    base = inputs.normal_leaves(ref.param_specs(m), ctx.seed, dev, dt)
    L, r, A = m["num_hidden_layers"], m["lora_rank"], t["adapters"]
    specs = []
    for name, (din, dout) in m["lora_targets"].items():
        specs.append(((name, "a"), (A, L, din, r), 1 / math.sqrt(din)))
        specs.append(((name, "b"), (A, L, r, dout), t["adapter_b_std"]))
    lora = inputs.normal_leaves(specs, ctx.seed + 1, dev)
    masks = _adapter_masks(t, m, ctx.seed)
    registry = AdapterRegistry(cfg, capacity=A, device=dev)
    for i in range(A):
        registry.register(f"a{i}", {"layers": {
            name: {"a": lora[(name, "a")][i], "b": lora[(name, "b")][i]}
            for name in m["lora_targets"]}}, modality_mask=masks[i])
    engine = ServingEngine(inputs.nest(base), cfg, registry,
                           batch_slots=t["batch_slots"], max_len=t["max_len"],
                           lora_impl=t["lora_impl"])
    return engine, registry, base, lora, masks


class Loop:
    """The open loop over the pool: the warm requests at once, then each
    at its due time from ``begin`` on, until ``end``."""

    def __init__(self, engine, pool, due):
        from repro_torch.launch.serving_engine import Request
        self.Request, self.engine, self.pool, self.due = (Request, engine,
                                                          pool, due)
        self.next = 0
        self.sent: dict[str, int] = {}  # rid -> pool index
        self.due_at: dict[str, float] = {}
        self.done_at: dict[str, float] = {}
        self.inflight: list[str] = []
        self.t0, self.k = None, 0

    def send(self, due_at: float) -> None:
        i = self.next
        self.next += 1
        prompt, out, ad = self.pool[i % len(self.pool)]
        rid = f"r{i}"
        self.engine.submit(self.Request(rid, prompt, f"a{ad}", out))
        self.sent[rid], self.due_at[rid] = i, due_at
        self.inflight.append(rid)

    def start(self, n: int) -> None:
        now = time.perf_counter()
        for _ in range(n):
            self.send(now)

    def begin(self) -> float:
        self.t0, self.k = time.perf_counter(), 0
        return self.t0

    def end(self) -> None:
        self.t0 = None

    def step(self) -> None:
        if self.t0 is not None:
            now = time.perf_counter()
            while (self.k < len(self.due)
                   and self.t0 + self.due[self.k] <= now):
                self.send(self.t0 + self.due[self.k])
                self.k += 1
        self.engine.step()
        now = time.perf_counter()
        lat = self.engine.latency
        for rid in [r for r in self.inflight if r in lat]:
            self.done_at[rid] = now
        self.inflight = [r for r in self.inflight if r not in lat]


def run(ctx) -> dict:
    from repro_torch.kernels.mdlora import ops as md_ops

    dev, t, m = ctx.device, ctx.traffic, ctx.config["model"]
    engine, registry, base, lora, masks = build(ctx)
    if ctx.plant is not None:
        ctx.plant(engine)
    loop = Loop(engine, _pool(t, ctx.seed, m["vocab_size"], t["adapters"]),
                _due(t, ctx.seed))
    loop.start(t["warm_requests"])
    for _ in range(t["warm_steps"]):
        loop.step()
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    spans, k4 = Spans(dev), Recorder()
    prof, work = None, {"rows": 0, "row_ctx": 0, "prompt": 0, "prompt_ctx": 0}
    if ctx.trace:
        engine._admit = spans.wrap("admit", _counted_admit(engine, work))
        engine._decode = _counted_decode(engine, work)
        md_ops.mdlora_matmul_multi = k4.wrap(md_ops.mdlora_matmul_multi,
                                             _k4_describer(engine))
    n_steps0 = len(engine.step_times)
    skip = (0, 0)  # the profiled stretch of step_times
    tok0 = sum(len(v) for v in engine.outputs.values())
    steps = 0
    t_w0 = loop.begin()
    deadline = t_w0 + ctx.seconds
    while time.perf_counter() < deadline:
        if ctx.trace and steps == 2:
            k4.on = True
            n0 = len(engine.step_times)
            prof = profile(lambda: [loop.step() for _ in range(
                t["profile_steps"])], dev)
            skip = (n0 - n_steps0, len(engine.step_times) - n_steps0)
            k4.on = False
            steps += t["profile_steps"]
            continue
        spans.on = ctx.trace
        loop.step()
        spans.on = False
        steps += 1
    _sync(dev)
    t_end = time.perf_counter()
    loop.end()
    window_s = t_end - t_w0
    backlog = len(loop.inflight)
    tokens = sum(len(v) for v in engine.outputs.values()) - tok0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    done = {rid: at - loop.due_at[rid] for rid, at in loop.done_at.items()
            if t_w0 <= at <= t_end}
    step_times = engine.step_times[n_steps0:]
    step_times = step_times[:skip[0]] + step_times[skip[1]:]
    work = dict(work)
    # answers are judged once finished: step on past the window's close
    # until the sample has enough to draw from
    for _ in range(10 * t["max_len"]):
        if len(loop.done_at) >= t["check_requests"]:
            break
        loop.step()
    outputs = {rid: list(engine.outputs[rid]) for rid in loop.done_at}

    # free the engine's state, then the reference
    del engine, registry
    loop.engine = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = check(ctx, base, lora, masks, loop, outputs)

    obs = {"config": ctx.config, "traffic": t, "window_s": window_s,
           "tokens": tokens, "latencies": sorted(done.values()),
           "step_times": step_times, "span_total": spans.total,
           "span_count": spans.count,
           "profile": summary(*prof) if prof else None,
           "k4_calls": k4.calls, "work": work if ctx.trace else None,
           "arrived": loop.k, "backlog": backlog}
    return {"e2e": {"setup_s": setup_s, "engine_tok_s": tokens / window_s},
            "obs": obs, "readings": readings, "attempted": len(done),
            "failed": 0, "peak": peak}


def _counted_admit(engine, work):
    """``_admit`` that also counts the prompt tokens it prefills and their
    summed context."""
    admit = engine._admit

    def counted(slot, req):
        n = len(req.prompt)
        work["prompt"] += n
        work["prompt_ctx"] += n * (n - 1) // 2
        return admit(slot, req)
    return counted


def _counted_decode(engine, work):
    """``_decode`` that also counts the rows it advances and their summed
    context."""
    decode = engine._decode

    def counted():
        act = engine.active
        work["rows"] += int(act.sum())
        work["row_ctx"] += int(engine.pos[act].sum())
        return decode()
    return counted


def sample(ctx, loop, outputs) -> list[str]:
    """The longest finished request and ``check_requests - 1`` others
    drawn from the seed."""
    fin = sorted(outputs, key=lambda r: loop.sent[r])
    size = {r: len(loop.pool[loop.sent[r] % len(loop.pool)][0])
            + len(outputs[r]) for r in fin}
    longest = max(fin, key=lambda r: size[r])
    rest = [r for r in fin if r != longest]
    rng = np.random.default_rng([ctx.seed, 2])
    k = min(ctx.traffic["check_requests"] - 1, len(rest))
    pick = [rest[i] for i in sorted(rng.choice(len(rest), size=k,
                                               replace=False))]
    return [longest] + pick


def reference_inputs(ctx, lora, masks, loop, outputs, rids):
    """Per request: the tokens run, its adapter, its fusion mask and the
    positions whose logits produced the served tokens."""
    m = ctx.config["model"]
    seqs, ads, fms, poss, served = [], [], [], [], []
    for rid in rids:
        prompt, _, a = loop.pool[loop.sent[rid] % len(loop.pool)]
        out = outputs[rid]
        seq = np.concatenate([prompt, np.asarray(out[:-1], np.int32)])
        seqs.append(torch.as_tensor(seq))
        ads.append({name: (lora[(name, "a")][a], lora[(name, "b")][a])
                    for name in m["lora_targets"]})
        fms.append(ref.block_mask(m, torch.as_tensor(masks[a])))
        poss.append(torch.arange(len(prompt) - 1, len(seq)))
        served.append(torch.as_tensor(out, dtype=torch.int64))
    return seqs, ads, fms, poss, served


def check(ctx, base, lora, masks, loop, outputs) -> dict:
    """The served gap of a sample of finished requests; with
    ``ctx.control`` also the control's: the gap of the token that the
    reference with fp8 weights puts first at each of the same positions."""
    rids = sample(ctx, loop, outputs)
    seqs, ads, fms, poss, served = reference_inputs(ctx, lora, masks, loop,
                                                    outputs, rids)
    m = ctx.config["model"]
    lg = ref.logits(m, base, seqs, ads, fms, poss)
    out = {"served_gap": served_gap(lg, served)}
    if getattr(ctx, "control", False):
        low = ref.logits(m, base, seqs, ads, fms, poss, weight_precision="fp8")
        out["control_gap"] = served_gap(lg, [x.argmax(1) for x in low])
        out["checked_tokens"] = float(sum(len(x) for x in served))
    return out


def served_gap(logits: list[torch.Tensor], served: list[torch.Tensor]
               ) -> float:
    """Widest gap by which a served token's reference logit lies below the
    reference's best at its position."""
    gap = 0.0
    for lg, s in zip(logits, served):
        got = lg.gather(1, s.to(lg.device)[:, None])[:, 0]
        gap = max(gap, float((lg.max(1).values - got).max()))
    return gap


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
