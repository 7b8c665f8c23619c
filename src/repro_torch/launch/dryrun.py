"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake mesh
and record memory, FLOP, byte and collective evidence per device.

Usage:
  python -m repro_torch.launch.dryrun --arch phi3-medium-14b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod] \\
      [--out-dir dryrun_out]

Each cell writes <out-dir>/<arch>__<shape>__<mesh>.json; existing files are
skipped (the grid resumes after an interruption).

No card is touched. The mesh is a ``DeviceMesh`` of 256 (16 x 16) or 512
(2 x 16 x 16) ranks over the "fake" process group (``launch/mesh.py``), as
the reference's runs on 512 fake XLA host devices. The step
(``step_fns.make_train_step``, ``make_prefill_step`` or
``make_serve_step``) runs once eagerly under ``FakeTensorMode``:
parameters, optimizer state, batch and caches are DTensors whose local
shards are fake CPU tensors placed by ``dist/sharding.py``, the
activations follow ``act_hint``, and every
collective that DTensor inserts goes to the fake group, which moves
nothing. While it runs, ``roofline.StepCounter`` counts per-device FLOPs,
unfused bytes and collectives on the local shards, and PyTorch's
``MemTracker`` the peak of live memory per device, parameters and optimizer
state included. The attention and the scan are the plain paths ("xla"):
the CUDA kernels take raw pointers, which fake tensors do not have. A
one-rank mesh runs the step on plain fake tensors (every placement is
trivial there).

Each cell traces its full depth (memory, and every layer's counts: an eager
trace repeats each layer) and, unless probes are skipped, two shallow
probes (L = n_sub, 2 n_sub), whose per-layer slope extrapolates to full
depth as the reference's does; both counts are recorded, with their
relative gap.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any

import torch

from repro_torch.tree import leaves, tree_map

DEFAULT_OUT = "dryrun_out"


def _fake(tree: Any, fake_mode) -> Any:
    """Stand-ins (``meta`` tensors) -> fake CPU tensors of the same shapes
    and dtypes; other leaves (an int step count) as they are."""
    with fake_mode:
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype)
                        if isinstance(t, torch.Tensor) else t, tree)


@contextlib.contextmanager
def _nccl_alltoall():
    """DTensor moves a shard from one tensor dim to another with one
    all-to-all, except on a CPU mesh, where it falls back to an all-gather
    of the whole tensor and a chunk (gloo has no all-to-all). The fake
    group's mesh is a CPU mesh, but the devices it stands for run NCCL: for
    the trace, the move takes DTensor's all-to-all op (its fake kernel
    gives the chunk; ``StepCounter`` counts it)."""
    from torch.distributed.tensor import placement_types as PT

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    before = PT.shard_dim_alltoall
    PT.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        PT.shard_dim_alltoall = before


def _mem_tracker():
    """PyTorch's ``MemTracker``, counting the local ops only. DTensor
    computes each op's output shape by running it on fake tensors of the
    global shape, under a fake mode of its own; recent releases of the
    tracker skip those ops, torch 2.11's counts them (a peak ~10x too high
    on a 256-rank mesh). This skips them on every release: ops under
    another fake mode than the one active on entry, and DTensor ops, which
    the tracker sees again as the local ops they desugar into."""
    from torch._guards import active_fake_mode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class LocalMemTracker(MemTracker):
        def __enter__(self):
            self._entry_fake_mode = active_fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            if active_fake_mode() is not self._entry_fake_mode:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def _trace_step(cfg, mod, shape, mesh, train_mode: str,
                strategy: str) -> dict:
    """Run one step on fake tensors placed on ``mesh``; -> per-device
    counts and memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding as SH
    from repro_torch.launch import roofline as RL
    from repro_torch.launch import step_fns as SF

    fm = FakeTensorMode(allow_non_fake_inputs=True)
    spread = mesh is not None and mesh.size() > 1

    def place(tree, specs):
        fake = _fake(tree, fm)
        if not spread:
            return fake
        with fm:
            return tree_map(
                lambda t, s: SH.distribute(mesh, t, s, local=True)
                if isinstance(t, torch.Tensor) else t, fake, specs)

    if spread:
        if strategy in ("fsdp", "replicated"):
            batch_axes = SH.data_axes(mesh) + (
                ("model",) if "model" in SH.axis_names(mesh) else ())
        else:
            batch_axes = SH.data_axes(mesh)
        SH.set_activation_mesh(mesh, batch_axes=batch_axes,
                               tp=(strategy == "tp"))
    params = SF.abstract_params(cfg)
    pspec = (SH.param_specs(cfg, params, mesh, train=(shape.kind == "train"),
                            strategy=strategy) if spread else None)
    specs_in = mod.input_specs(shape, cfg)
    if shape.kind == "train":
        tr, _ = SF.split_trainable(params, train_mode)
        opt = SF.abstract_opt_state(tr)
        if spread:
            pspec_tr = pspec["lora"] if train_mode == "lora" else pspec
            ospec = SH.opt_state_specs(pspec_tr, opt, mesh)
            bspec = SH.batch_specs(specs_in, mesh, cfg, strategy)
        else:
            ospec = bspec = None
        fn = SF.make_train_step(cfg, train_mode=train_mode)
        args = (place(params, pspec), place(opt, ospec),
                place(specs_in, bspec))
    elif shape.kind == "prefill":
        bspec = SH.batch_specs(specs_in, mesh, cfg) if spread else None
        fn = SF.make_prefill_step(cfg)
        args = (place(params, pspec), place(specs_in, bspec))
    else:  # decode: the caches are written in place (donated)
        caches = SF.abstract_caches(cfg, shape.global_batch, shape.seq_len)
        cspec = SH.cache_specs(cfg, caches, mesh) if spread else None
        tspec = (SH.batch_specs(specs_in["token"], mesh, cfg) if spread
                 else None)
        fn = SF.make_serve_step(cfg)
        args = (place(params, pspec), place(caches, cspec),
                place(specs_in["token"], tspec),
                _fake(specs_in["pos"], fm))
    tracked = [t for t in leaves(list(args)) if isinstance(t, torch.Tensor)]
    counter = RL.StepCounter(fm)
    mem = _mem_tracker()
    mem.track_external(*tracked)
    arg_bytes = mem.get_tracker_snapshot()
    grad = contextlib.nullcontext() if shape.kind == "train" \
        else torch.no_grad()
    try:
        with counter, mem, implicit_replication(), _nccl_alltoall(), grad:
            out = fn(*args)
            outs = [t for t in leaves(list(out) if isinstance(out, tuple)
                                      else [out])
                    if isinstance(t, torch.Tensor)]
    finally:
        SH.set_activation_mesh(None)
    peak = mem.get_tracker_snapshot("peak")
    dev = torch.device("cpu")
    peak_b = int(peak.get(dev, {}).get("Total", 0))
    arg_b = int(arg_bytes.get(dev, {}).get("Total", 0))
    ids = {id(t) for t in tracked}
    out_b = sum(_local_bytes(t) for t in outs if id(t) not in ids)
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "coll": counter.collectives, "peak_bytes": peak_b,
            "argument_bytes": arg_b, "output_bytes": out_b}


def _local_bytes(t: torch.Tensor) -> int:
    local = getattr(t, "_local_tensor", t)
    return local.numel() * local.element_size()


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             train_mode: str = "lora", hillclimb: dict | None = None,
             probes: tuple | str = (), full_scan: bool = True, *,
             mesh=None, cfg=None, shape=None,
             strategy: str | None = None) -> dict:
    """One dry-run cell: a full-depth trace (memory and counts) and, unless
    ``probes == "skip"``, two probes whose per-layer slope extrapolates the
    counts to full depth: metric(L) = const + per_layer * L.

    ``mesh``, ``cfg``, ``shape`` and ``strategy`` override the production
    mesh, ``FULL``, ``SHAPES[shape_name]`` and ``pick_strategy`` (a
    miniature cell in a test)."""
    from repro_torch.configs import base
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import pattern

    mod = base.get_arch(arch)
    cfg0 = cfg or mod.FULL
    shape = shape or base.SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    if not base.supports(cfg0, shape):
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "long_500k requires sub-quadratic attention "
                          "(pure full-attention arch)"}

    tweaks: dict = {"q_chunk": 256}
    if cfg0.family == "moe":
        tweaks |= {"moe_impl": "dense"}  # the reference's mesh baseline
    if shape.kind == "train":
        # bf16 LoRA compute (fp32 Adam moments regardless), full remat,
        # sequence-sharded residual, chunked CE: the reference's settings
        tweaks |= {"remat": "full", "seq_shard": True, "loss_chunks": 8,
                   "lora_dtype": "bfloat16"}
    if hillclimb:
        tweaks |= hillclimb
    cfg = dataclasses.replace(cfg0, **tweaks)

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    strategy = strategy or SH.pick_strategy(cfg, shape.kind)
    if strategy == "fsdp" and shape.global_batch % n_chips != 0:
        # global batch < devices: pure FSDP leaves the model axis without a
        # batch dim; hybrid TP(model) x DP(pod, data) keeps every device busy
        strategy = "tp"
    n_sub = pattern(cfg)[0] if cfg.family in ("dense", "moe", "vlm",
                                              "audio") else 1
    result = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
              "status": "ok", "n_chips": n_chips, "strategy": strategy,
              "train_mode": train_mode if shape.kind == "train" else None,
              "config_tweaks": tweaks, "hillclimb": hillclimb or {},
              "counted_by": "eager trace on fake tensors (FakeTensorMode, "
                            "DTensor on the fake process group)"}

    full = None
    if full_scan:  # --- 1. full depth: memory and every layer's counts ---
        t0 = time.time()
        full = _trace_step(cfg, mod, shape, mesh, train_mode, strategy)
        result["compile_s"] = round(time.time() - t0, 1)
        peak = full["peak_bytes"]
        result["memory"] = {
            "argument_bytes": full["argument_bytes"],
            "temp_bytes": peak - full["argument_bytes"],
            "output_bytes": full["output_bytes"],
            "peak_bytes": peak,
            "per_device_gb": round(peak / 2**30, 3),
            "fits_80gb_hbm": peak < RL.HBM_BYTES,
            "tracked_by": "MemTracker (live storages of the local shards; "
                          "parameters, optimizer state, batch and caches "
                          "tracked from the start)",
        }
    if probes == "skip":
        return result

    # --- 2. depth probes: per-layer slope, extrapolated ---------------------
    probes = probes or (n_sub, 2 * n_sub)
    probe_stats = []
    for L in probes:
        pcfg = dataclasses.replace(cfg, n_layers=L)
        t1 = time.time()
        got = _trace_step(pcfg, mod, shape, mesh, train_mode, strategy)
        coll = got["coll"]
        probe_stats.append({
            "layers": L, "flops": got["flops"], "bytes": got["bytes"],
            "coll_bytes": float(coll.total(1)), "coll_counts": coll.counts,
            "compile_s": round(time.time() - t1, 1)})
    (p1, p2) = probe_stats[-2:]
    L_full = cfg.n_layers

    def extrap(key):
        per_layer = (p2[key] - p1[key]) / max(p2["layers"] - p1["layers"], 1)
        const = p1[key] - per_layer * p1["layers"]
        return max(const + per_layer * L_full, 0.0), per_layer

    flops, flops_pl = extrap("flops")
    byts, bytes_pl = extrap("bytes")
    cbytes, cbytes_pl = extrap("coll_bytes")
    terms = {
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": byts,
        "bytes_kind": "unfused: inputs + outputs of every local op",
        "collective_bytes_per_device": cbytes,
        "per_layer": {"flops": flops_pl, "bytes": bytes_pl,
                      "coll_bytes": cbytes_pl},
        "collective_counts_probe": p2["coll_counts"],
        "t_compute_s": flops / RL.PEAK_FLOPS,
        "t_memory_s": byts / RL.HBM_BW,
        "t_collective_s": cbytes / RL.LINK_BW,
    }
    terms["dominant"] = max(
        (("compute", terms["t_compute_s"]), ("memory", terms["t_memory_s"]),
         ("collective", terms["t_collective_s"])), key=lambda kv: kv[1])[0]
    if full is not None:
        counted = RL.roofline_terms(full["flops"], full["bytes"],
                                    full["coll"])
        terms["full_depth"] = counted
        terms["extrapolation_gap"] = {
            k: abs(x - c) / max(abs(c), 1.0) for k, x, c in (
                ("flops", flops, counted["hlo_flops_per_device"]),
                ("bytes", byts, counted["hlo_bytes_per_device"]),
                ("coll_bytes", cbytes,
                 counted["collective_bytes_per_device"]))}
    mf = RL.model_flops(cfg0, shape, train_mode)
    result["probes"] = probe_stats
    result["roofline"] = terms
    result["model_flops"] = mf
    result["useful_flops_ratio"] = (mf["model_flops"] / n_chips
                                    / max(flops, 1.0))
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--train-mode", default="lora", choices=["lora", "full"])
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--hillclimb-json", default=None,
                    help="JSON dict of ModelConfig overrides (perf iteration)")
    ap.add_argument("--skip-probes", action="store_true",
                    help="the full-depth trace only (memory and counts)")
    args = ap.parse_args(argv)

    from repro_torch.configs import base
    from repro_torch.launch.mesh import close_process_group

    archs = base.list_archs() if args.arch == "all" else [args.arch]
    shapes = list(base.SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    hc = json.loads(args.hillclimb_json) if args.hillclimb_json else None

    os.makedirs(args.out_dir, exist_ok=True)
    failures = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                if hc:
                    tag += "__hc" + "-".join(f"{k}={v}" for k, v in
                                             sorted(hc.items()))
                out = os.path.join(args.out_dir, tag + ".json")
                if os.path.exists(out) and not args.force:
                    print(f"[skip cached] {tag}")
                    continue
                print(f"[run] {tag} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mp, args.train_mode, hc,
                                   probes="skip" if args.skip_probes else ())
                except Exception as e:  # noqa: BLE001 — record and go on
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": repr(e)[:2000],
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                with open(out, "w") as f:
                    json.dump(res, f, indent=1, default=str)
                print(f"[done] {tag}: {_summary(res)}", flush=True)
        close_process_group()  # the next mesh has another world size
    return 1 if failures else 0


def _summary(res: dict) -> str:
    msg = res["status"]
    if res["status"] == "error":
        return msg + " " + res["error"][:300]
    if "memory" in res:
        msg += (f" {res.get('strategy')} trace={res.get('compile_s')}s "
                f"mem={res['memory']['per_device_gb']}GiB")
    if "roofline" in res:
        r = res["roofline"]
        msg += (f" dom={r['dominant']} tc={r['t_compute_s']:.4f} "
                f"tm={r['t_memory_s']:.4f} tx={r['t_collective_s']:.4f}")
    return msg


if __name__ == "__main__":
    sys.exit(main())
