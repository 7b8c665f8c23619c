"""Traffic of kind ``engine_loop_moe``: the ``engine_loop`` open loop (its
pool, arrivals, set-up, window and profiled steps, read there) on an MoE
model that the program serves dropless.

``engine_loop.py`` is loaded under its own module name, and in that copy
alone its reference becomes ``reference/mixtral.py``, its build draws the
router in fp32 (as the program keeps it), its field check adds the experts,
the experts per token and ``moe_impl``, its check adds a second reading,
and the summary of the profiled steps adds the device time of the kernels
launched inside the program's MoE spans. ``engine_loop.py`` itself is read
and left as it is.

Before anything is drawn, the program must know ``moe_impl="dropless"``:
a program without it fails here within seconds.

While the engine serves, the experts it chooses in each layer of each
admission and decode step are recorded (``RouteLog``: the ids ``moe.route``
returns, kept on the device; the wrappers cost a few microseconds a step).
Readings that decide ``correct``, after the window, of ``engine_loop``'s
sample of finished requests: ``served_gap`` as ``engine_loop``'s, with the
reference sending each (token, layer) to the experts the program chose for
it; and ``route_mismatch``, the share of (token, layer) whose chosen expert
set is not the one the reference's own router picks there. Routing on
random weights sits near ties: a sound bf16 program picks the other expert
at some of them, and a reference left to its own choice then carries that
difference into every later layer and, through attention, every later
token, so the logits would part far beyond bf16's rounding. Each decision
is judged by ``route_mismatch``, and the arithmetic around it by
``served_gap``.
"""
from __future__ import annotations

import math
from bisect import bisect_right

import torch

from harness import HERE, load_module, say, summary

el = load_module(HERE / "runners" / "engine_loop.py",
                 "portbench_runner_engine_loop_moe_base")
ref = load_module(HERE / "reference" / "mixtral.py", "portbench_ref_mixtral")
el.ref = ref

MOE_SPANS = ("moe.route", "moe.experts", "moe.combine")


def _require_dropless() -> None:
    """The program's MoE layer must take ``impl="dropless"``."""
    from repro_torch.models import moe
    z = torch.zeros
    p = {"router": z(4, 2), "wi": z(2, 4, 4), "wg": z(2, 4, 4),
         "wo": z(2, 4, 4)}
    try:
        moe.moe_mlp(p, z(1, 1, 4), top_k=1, impl="dropless")
    except ValueError as e:
        raise RuntimeError("the program has no dropless MoE path "
                           "(moe_impl='dropless'), which this cell serves"
                           ) from e


def _port_config(c: dict):
    cfg = el._port_config(c)
    m = c["model"]
    for ours, want in (("n_experts", m["num_local_experts"]),
                       ("top_k", m["num_experts_per_tok"]),
                       ("moe_impl", "dropless")):
        if getattr(cfg, ours) != want:
            raise ValueError(f"the port's {ours} = {getattr(cfg, ours)!r} "
                             f"is not the configuration's {want!r}")
    return cfg


def build(ctx):
    """``engine_loop.build`` with the router drawn in fp32, and the
    experts the engine chooses recorded from its first request on."""
    from repro_torch.launch.serving_engine import (AdapterRegistry,
                                                   ServingEngine)

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    m = c["model"]
    cfg = _port_config(c)
    dt = getattr(torch, m["torch_dtype"])
    specs = ref.param_specs(m)
    base = el.inputs.normal_leaves([s for s in specs if s[0] != ref.ROUTER],
                                   ctx.seed, dev, dt)
    base.update(el.inputs.normal_leaves(
        [s for s in specs if s[0] == ref.ROUTER], ctx.seed + 2, dev))
    L, r, A = m["num_hidden_layers"], m["lora_rank"], t["adapters"]
    lspecs = []
    for name, (din, dout) in m["lora_targets"].items():
        lspecs.append(((name, "a"), (A, L, din, r), 1 / math.sqrt(din)))
        lspecs.append(((name, "b"), (A, L, r, dout), t["adapter_b_std"]))
    lora = el.inputs.normal_leaves(lspecs, ctx.seed + 1, dev)
    masks = el._adapter_masks(t, m, ctx.seed)
    registry = AdapterRegistry(cfg, capacity=A, device=dev)
    for i in range(A):
        registry.register(f"a{i}", {"layers": {
            name: {"a": lora[(name, "a")][i], "b": lora[(name, "b")][i]}
            for name in m["lora_targets"]}}, modality_mask=masks[i])
    engine = ServingEngine(el.inputs.nest(base), cfg, registry,
                           batch_slots=t["batch_slots"], max_len=t["max_len"],
                           lora_impl=t["lora_impl"])
    ctx.routes = RouteLog(engine)
    return engine, registry, base, lora, masks


class RouteLog:
    """The experts the program chose while it served: ``moe.route``'s ids
    of every layer of every admission and decode step, kept on the device
    (nothing is copied while the engine runs), and the request each decode
    row held. The engine's ``_admit`` and ``_decode`` and the program's
    ``moe.route`` are wrapped until ``close``."""

    def __init__(self, engine):
        from repro_torch.models import moe
        self.moe, self.inner, self.cur = moe, moe.route, None
        self.admits: dict[str, list] = {}  # rid -> L x [1, P, k]
        # per decode step: ({slot: rid}, L x [B, 1, k])
        self.steps: list[tuple[dict, list]] = []
        admit, decode = engine._admit, engine._decode

        def admitting(slot, req):
            self.cur = self.admits[req.rid] = []
            try:
                return admit(slot, req)
            finally:
                self.cur = None

        def decoding():
            self.cur = []
            self.steps.append(({s: engine.requests[s].rid
                                for s in range(engine.B) if engine.active[s]},
                               self.cur))
            try:
                return decode()
            finally:
                self.cur = None

        engine._admit, engine._decode = admitting, decoding
        moe.route = self.route

    def route(self, p, x, top_k):
        out = self.inner(p, x, top_k)
        if self.cur is not None:
            self.cur.append(out[2])
        return out

    def close(self) -> None:
        self.moe.route = self.inner

    def of(self, rid: str) -> torch.Tensor:
        """[L, S, k]: the experts of each layer at each position the engine
        ran for ``rid``, its prompt's and then one per decode step."""
        parts = [torch.stack(self.admits[rid])[:, 0]]
        for rows, ids in self.steps:
            for slot, r in rows.items():
                if r == rid:
                    parts.append(torch.stack([i[slot] for i in ids]))
        return torch.cat(parts, 1)


def route_mismatch(got: list[torch.Tensor], want: list[torch.Tensor]
                   ) -> float:
    """Share of (token, layer) whose expert set differs."""
    diff = n = 0
    for g, w in zip(got, want):
        g, w = g.sort(-1).values.cpu(), w.sort(-1).values.cpu()
        if g.shape != w.shape:
            return 1.0
        diff += int((g != w).any(-1).sum())
        n += g.shape[0] * g.shape[1]
    return diff / n


def check(ctx, base, lora, masks, loop, outputs) -> dict:
    """The served gap of a sample of finished requests, the reference
    sending every (token, layer) to the experts the program chose, and the
    share of (token, layer) whose chosen experts are not the reference's
    router's own; with ``ctx.control`` also the control's of both: the fp8
    reference's first token at each served position and its router's
    choice."""
    ctx.routes.close()
    rids = el.sample(ctx, loop, outputs)
    seqs, ads, fms, poss, served = el.reference_inputs(ctx, lora, masks,
                                                       loop, outputs, rids)
    m = ctx.config["model"]
    chosen = [ctx.routes.of(rid) for rid in rids]
    lg, own = ref.forward(m, base, seqs, ads, fms, poss, routes=chosen)
    out = {"served_gap": el.served_gap(lg, served),
           "route_mismatch": route_mismatch(chosen, own)}
    if getattr(ctx, "control", False):
        low, low_own = ref.forward(m, base, seqs, ads, fms, poss,
                                   weight_precision="fp8", routes=chosen)
        out["control_gap"] = el.served_gap(lg, [x.argmax(1) for x in low])
        out["control_route_mismatch"] = route_mismatch(chosen, low_own)
        out["checked_tokens"] = float(sum(len(x) for x in served))
    return out


# a kernel of the expert products: CUTLASS's grouped GEMM and its set-up
# kernel (``torch._grouped_mm`` in bf16), or a cuBLAS product
PRODUCT = ("grouped_gemm", "GroupProblemShape", "gemm", "Gemm", "nvjet",
           "xmma")


def moe_breakdown(prof) -> dict | None:
    """Device seconds of the kernels launched inside each MoE span (a
    kernel belongs to the span open on the host when its launch call
    started, matched by the profiler's correlation id), and per
    ``moe.experts`` span [assignments, rows per expert, seconds of its
    product kernels]; None where the program has no MoE spans."""
    from torch.autograd import DeviceType
    try:
        from repro_torch import trace
    except ImportError:  # a program without spans
        return None
    recs = [r for r in trace.records() if r.name in MOE_SPANS]
    if not recs:
        return None
    launch, kernels = {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            kernels.append((ev.correlation_id(), ev.name(), ev.start_ns(),
                            ev.end_ns()))
        elif ev.name().startswith("cu"):
            launch[ev.correlation_id()] = ev.start_ns()
    starts = [r.start for r in recs]
    span_s = dict.fromkeys(MOE_SPANS, 0.0)
    products = {id(r): 0.0 for r in recs}
    names: dict[str, list] = {}
    for corr, name, s, e in kernels:
        t = launch.get(corr)
        i = -1 if t is None else bisect_right(starts, t) - 1
        if i < 0 or t >= recs[i].end:
            continue
        r, sec = recs[i], (e - s) * 1e-9
        span_s[r.name] += sec
        if r.name == "moe.experts":
            k = names.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += sec
            if any(p in name for p in PRODUCT):
                products[id(r)] += sec
    experts = [r for r in recs if r.name == "moe.experts"]
    loads = torch.stack([r.attrs["load"] for r in experts]).cpu().tolist()
    return {"span_s": span_s,
            "calls": [[r.attrs["assignments"], ld, products[id(r)]]
                      for r, ld in zip(experts, loads)],
            "experts_kernels": sorted(([n[:110], *v] for n, v in
                                       names.items()), key=lambda x: -x[2])}


def _summary(prof, window_s: float) -> dict:
    out = summary(prof, window_s)
    out["moe"] = moe_breakdown(prof)
    return out


el.build, el.check, el.summary = build, check, _summary


def run(ctx) -> dict:
    _require_dropless()
    res = el.run(ctx)
    prof = res["obs"]["profile"]
    if prof and prof["moe"]:
        say("moe.experts kernels: " + "; ".join(
            f"{n} x{c} {s:.6f} s"
            for n, c, s in prof["moe"]["experts_kernels"][:8]))
    return res
