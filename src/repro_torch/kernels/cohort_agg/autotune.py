"""Launch-plan selection for the cohort-agg and mdlora kernels.

The reference tiles its Pallas kernels into ``bd``-row blocks (and (bt, bf,
bd) cells for the projections) and picks the tile per shape. Its rule
stays here, exactly, as the untimed branch: ``impl != "pallas"`` or
``interpret`` takes the largest divisor of D within the VMEM accumulator
budget (``largest_divisor``, ``candidate_bds``, ``mdlora_candidates``).

On the card the same selectors sweep what the CUDA kernels are planned by,
in place of the Pallas tiles:

* kernels 1-2 (``cohort_agg_divergence``, ``_quant``): the ``AggPlan``
  (rows per tile, client lanes, client splits; ``agg_candidates``);
* kernel 3 (``mdlora_matmul``): the count of persistent blocks
  (``fused_candidates``); every count gives the same bits;
* kernel 4 (``mdlora_matmul_multi``): the split plan, bf16 (L, sd, su, ug)
  or fp32 (sd, su) (``multi_candidates``).

Each candidate runs a warm-up call, then ``_SWEEP_REPS`` timed reps
(replays of a CUDA graph of ``_REP_CALLS`` calls), and the median decides;
the pick is cached per shape and SM count. Kernels 3-4 leave the token
count T out of the key: their plans must not read the batch, so a row's
result does not depend on the rows beside it. The ops' default plans are
not these picks: a sweep may choose differently from run to run, and
kernels 1, 2 and 4 add their partial sums in the plan's order.
``TIMINGS`` keeps each sweep's (plan, ms) pairs.
"""
from __future__ import annotations

import math

import torch

# power-of-two cells the sweep considers (snapped to divisors of D)
_CANDIDATE_CAPS = (64, 128, 256, 512)
_SWEEP_REPS = 3
_REP_CALLS = 10  # calls per timed rep: one call is a few microseconds
# accumulators are 2*(bd*r + bd) f32 plus the streamed (bd, r) input tile;
# the reference keeps them well under the ~16 MB/core VMEM
_VMEM_ACC_BUDGET = 4 * 2**20

_CACHE: dict[tuple, object] = {}
TIMINGS: dict[tuple, list[tuple[object, float]]] = {}


def largest_divisor(D: int, cap: int) -> int:
    """Largest divisor of D that is <= cap (>= 1)."""
    b = max(1, min(int(cap), int(D)))
    while D % b:
        b -= 1
    return b


def candidate_bds(D: int, r: int) -> list[int]:
    """Distinct, VMEM-feasible candidate block sizes for row dimension D."""
    cands = set()
    for cap in _CANDIDATE_CAPS:
        bd = largest_divisor(D, cap)
        if 4 * (2 * bd * (r + 1) + bd * r) <= _VMEM_ACC_BUDGET:
            cands.add(bd)
    return sorted(cands) or [1]


def clear_cache() -> None:
    _CACHE.clear()
    TIMINGS.clear()


def _sms() -> int:
    from repro_torch.kernels.runtime import resolve_device

    dev = resolve_device(None)  # the timed branch needs the card
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _sweep(key: tuple, cands: list, run) -> object:
    """Time ``run(cand)`` for every candidate; -> the fastest (median of
    the reps), recording every (cand, ms per call) in TIMINGS[key]. A rep
    replays a CUDA graph of ``_REP_CALLS`` calls, so the device time is
    timed and not the host's enqueue (a call is a few microseconds)."""
    times = []
    for cand in cands:
        side = torch.cuda.Stream()  # warm up off the capture stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(cand)  # first launch, lazy workspaces
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(_REP_CALLS):
                run(cand)
        reps = []
        for _ in range(_SWEEP_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            reps.append(start.elapsed_time(end) / _REP_CALLS)
        del graph
        times.append((cand, sorted(reps)[len(reps) // 2]))
    TIMINGS[key] = times
    return min(times, key=lambda ct: ct[1])[0]


# ---------------------------------------------------------------------------
# cohort aggregation (kernels 1-2)
# ---------------------------------------------------------------------------


def agg_candidates(N: int, D: int, r: int, sms: int) -> list:
    """The AggPlans the sweep times: for each lane count the kernel takes
    (1, 2, 4, 8, at most N rounded up to a power of two), the most whole
    rows its span threads cover, and one split, one wave of the card's
    resident slots, and twice that (each lane keeping at least
    MIN_LANE_CLIENTS clients per split); ``plan_agg``'s plan among them."""
    from repro_torch.kernels.cohort_agg import ops

    base = ops.plan_agg(N, D, r, sms)
    vec, sr = base.vec, r // base.vec
    cands = {base}
    max_lanes = min(ops.MAX_LANES, 1 << max(0, math.ceil(math.log2(N))))
    for lanes in (1, 2, 4, 8):
        ts = ops.AGG_THREADS // lanes
        if lanes > max_lanes or (lanes > 1 and ts < sr):
            continue
        rows = max(1, min(D, ts // sr))
        tiles = -(-D // rows)
        most = max(1, -(-N // (lanes * ops.MIN_LANE_CLIENTS)))
        wave = max(1, ops.AGG_BLOCKS_PER_SM * sms // tiles)
        for splits in {1, min(most, wave), min(most, 2 * wave)}:
            cands.add(ops.AggPlan(vec, rows, lanes, splits))
    return sorted(cands)


def select_block_size(shape: tuple[int, int, int], impl: str = "pallas",
                      interpret: bool = True, quant: bool = False):
    """Untimed (``impl != "pallas"`` or ``interpret``): the reference's
    ``bd`` for a [N, D, r] reduction. Timed (on the card): the fastest
    ``AggPlan`` of the fp32 (or, ``quant``, the int8) kernel."""
    N, D, r = (int(x) for x in shape)
    if impl != "pallas" or interpret:
        key = (N, D, r, impl, bool(interpret), bool(quant))
        if key not in _CACHE:
            _CACHE[key] = candidate_bds(D, r)[-1]
        return _CACHE[key]
    sms = _sms()
    key = ("agg", N, D, r, bool(quant), sms)
    if key not in _CACHE:
        _CACHE[key] = _timed_select_agg(key, N, D, r, sms, quant)
    return _CACHE[key]


def _timed_select_agg(key, N: int, D: int, r: int, sms: int, quant: bool):
    from repro_torch.kernels.cohort_agg import ops

    g = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(device="cuda", generator=g)
    W = torch.rand((N, D), **kw)
    C = (torch.rand((N, D), **kw) < 0.5).float()
    if quant:
        q = torch.randint(-127, 128, (N, D, r), dtype=torch.int8, **kw)
        s = torch.rand((N,), **kw) * 1e-2
        t = torch.randint(0, 4, (N,), **kw).float()

        def run(plan):
            return ops.cohort_agg_divergence_quant(q, s, W, C, t, 0.5,
                                                   plan=plan)
    else:
        deltas = torch.randn((N, D, r), **kw)

        def run(plan):
            return ops.cohort_agg_divergence(deltas, W, C, plan=plan)

    return _sweep(key, agg_candidates(N, D, r, sms), run)


# ---------------------------------------------------------------------------
# mdlora (fused block-LoRA projection) selection (kernels 3-4)
# ---------------------------------------------------------------------------


def _mdlora_vmem_bytes(bt: int, bf: int, bd: int, r: int) -> int:
    # x tile + w0 tile + a tile + b tile + acc/u scratch, fp32
    return 4 * (bt * bd + bd * bf + bd * r + r * bf + bt * (bf + r))


def mdlora_candidates(T: int, D: int, F: int, r: int,
                      multi: bool) -> list[tuple[int, int, int]]:
    """Distinct VMEM-feasible (bt, bf, bd) cells (bt = 1 when ``multi``)."""
    cands = set()
    for cap in _CANDIDATE_CAPS:
        bt = 1 if multi else largest_divisor(T, cap)
        bf, bd = largest_divisor(F, cap), largest_divisor(D, cap)
        if _mdlora_vmem_bytes(bt, bf, bd, r) <= _VMEM_ACC_BUDGET:
            cands.add((bt, bf, bd))
    return sorted(cands) or [(1, largest_divisor(F, 1), largest_divisor(D, 1))]


def fused_candidates(tiles: int, default: int, sms: int) -> list[int]:
    """Persistent block counts for kernel 3: the default (as many as are
    resident), one block per tile or per two or four tiles, and one, two
    or four per SM, each at most one per tile."""
    return sorted({min(tiles, c) for c in (
        default, tiles, -(-tiles // 2), -(-tiles // 4), sms, 2 * sms,
        4 * sms)})


def multi_candidates(D: int, F: int, r: int, sms: int,
                     dtype: torch.dtype) -> list[tuple]:
    """Split plans for kernel 4. bf16 (L, sd, su, ug): base splits of 1, 2,
    4, 8 and 16 ring stages' worth and ``plan_multi``'s, each with 4 and 16
    rows per bottleneck block; fp32 (sd, su): base splits of 1, 2, 4 and 8
    and ``_plan``'s, su fixed."""
    from repro_torch.kernels.mdlora import ops

    if dtype == torch.bfloat16:
        L0, _, su, _ = ops.plan_multi(D, F, sms)
        stages = -(-D // ops.STAGE_K)
        lens = {L0} | {-(-stages // n) * ops.STAGE_K for n in (1, 2, 4, 8, 16)
                       if n <= stages}
        return sorted((L, -(-D // L), su, ug) for L in lens for ug in (4, 16))
    sd0, su = ops._plan(D, F, r, sms)
    return sorted({(sd0, su)} | {(n, su) for n in (1, 2, 4, 8)
                                 if n <= max(1, D // 256)})


def select_mdlora_blocks(shape: tuple[int, int, int, int],
                         impl: str = "pallas", interpret: bool = True,
                         multi: bool = False, n_adapters: int = 1,
                         dtype: torch.dtype = torch.float32):
    """Untimed (``impl != "pallas"`` or ``interpret``): the reference's
    (bt, bf, bd) for a [T, D] x [D, F] (rank r) projection. Timed (on the
    card, in ``dtype``): kernel 3's persistent block count, or (``multi``)
    kernel 4's split plan; the key leaves T out."""
    T, D, F, r = (int(x) for x in shape)
    if impl != "pallas" or interpret:
        key = ("mdlora", T, D, F, r, impl, bool(interpret), bool(multi),
               int(n_adapters))
        if key not in _CACHE:
            _CACHE[key] = mdlora_candidates(T, D, F, r, multi)[-1]
        return _CACHE[key]
    sms = _sms()
    key = ("mdlora", D, F, r, bool(multi), int(n_adapters), str(dtype), sms)
    if key not in _CACHE:
        _CACHE[key] = _timed_select_mdlora(key, T, D, F, r, multi,
                                           n_adapters, dtype, sms)
    return _CACHE[key]


def _timed_select_mdlora(key, T: int, D: int, F: int, r: int, multi: bool,
                         n_adapters: int, dtype: torch.dtype, sms: int):
    from repro_torch.kernels.mdlora import ops

    g = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(device="cuda", generator=g)
    x = torch.randn((T, D), **kw).to(dtype)
    w0 = (torch.randn((D, F), **kw) * 0.05).to(dtype)
    if multi:
        A = max(int(n_adapters), 1)
        a = torch.randn((A, D, r), **kw) * 0.1
        b = torch.randn((A, r, F), **kw) * 0.1
        idx = torch.randint(0, A, (T,), dtype=torch.int32, **kw)
        mask = (torch.rand((T, D), **kw) < 0.8).float()
        with torch.no_grad():
            return _sweep(key, multi_candidates(D, F, r, sms, dtype),
                          lambda plan: ops.mdlora_matmul_multi(
                              x, w0, a, b, idx, mask, 2.0, plan=plan))
    a = (torch.randn((D, r), **kw) * 0.1).to(dtype)
    b = (torch.randn((r, F), **kw) * 0.1).to(dtype)
    mask = (torch.rand((D,), **kw) < 0.8).float()
    with torch.no_grad():
        ops.mdlora_matmul(x, w0, a, b, mask, 2.0)
        default = ops.fused_blocks()
        tiles = -(-T // 32) * -(-F // 32)  # the kernel's 32 x 32 tiles
        return _sweep(key, fused_candidates(tiles, default, sms),
                      lambda n: ops.mdlora_matmul(x, w0, a, b, mask, 2.0,
                                                  plan=n))
