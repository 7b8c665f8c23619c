"""The event-driven asynchronous RELIEF runtime on the paper's HAR setting.

Divergence-guided allocation under buffered, staleness-discounted cohort
aggregation, on the paper's coupled fleet (3 full / 3 mid / 2 low devices for
PAMAP2) at a chosen compute gap, with the full-width Backbone 1 by default
(``--backbone b2``: the frozen patch-transformer encoders with LoRA and the
block-LoRA fusion layer, whose local steps run the fused projection kernel).
Every server flush runs the fused cohort-agg CUDA kernel (``--codec none``)
or the int8 quantized-ingest kernel (``--codec int8``). First a synchronous
FedAvg run (``FedRun``) does the same total client work on the same device
model, and the last line gives the simulated wall-clock speedup over it.

    python -m repro_torch.launch.train_async_har [--rounds 50] [--buffer 4]
        [--staleness-exp 0.5] [--hetero 100] [--codec none|int8]
        [--backbone b1|b2] [--small] [--device cuda]

Kept deviation from the reference's ``examples/train_async_har.py``, whose
scenario takes the narrow Backbone 1 (``small_model=True``): the default
here is the full-width Backbone 1; ``--small`` builds exactly the
reference's model, fleet and ``AsyncFedConfig``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import strategies
from repro_torch.core.async_engine import AsyncFedConfig, AsyncFedRun
from repro_torch.core.engine import FedConfig, FedRun
from repro_torch.core.tasks import MMTask
from repro_torch.data import HARDataset, get_provider
from repro_torch.kernels.runtime import resolve_device
from repro_torch.sim import make_fleet

WINDOWS_PER_SUBJECT = 200
BACKBONES = {"b1": "cnn", "b2": "transformer"}


def build(dataset: str = "pamap2", buffer: int = 4,
          staleness_exp: float = 0.5, hetero: float = 100.0,
          jitter: float = 0.0, codec: str = "none", rounds: int = 50,
          small: bool = False, seed: int = 0,
          device: torch.device | str | None = None, backbone: str = "b1",
          strategy: str = "async_relief", faults=None
          ) -> tuple[AsyncFedRun, HARDataset]:
    """The run the command line describes, ready for ``run.run(dataset)``:
    the settings of the reference's scenario ``train_async_har`` (paper
    fleet, ``windows_per_subject=200``, ``t_overhead=1e-3``, utilization
    2e-5, E=5 x 4 steps of batch 32 at lr 1e-3). ``strategy`` names an
    async strategy (``relief_krum`` etc.); ``faults`` is a
    ``sim.FaultModel``."""
    dev = resolve_device(device)
    provider = get_provider(dataset)
    M = len(provider.modalities())
    fleet = make_fleet(3, 3, 2 if dataset == "pamap2" else 4, M=M,
                       mid_modalities=tuple(range(min(2, M))),
                       low_modalities=(0,), hetero_scale=hetero)
    ds = provider.build(seed=seed, n_clients=fleet.N,
                        windows_per_subject=WINDOWS_PER_SUBJECT)
    strat = strategies.get(strategy, buffer_size=buffer,
                           staleness_exponent=staleness_exp)
    fed = AsyncFedConfig(rounds=rounds, local_epochs=5, steps_per_epoch=4,
                         batch_size=32, lr=1e-3,
                         eval_every=max(rounds // 2, 1), t_overhead=1e-3,
                         utilization=2e-5, seed=seed, jitter_sigma=jitter,
                         uplink_codec=codec, faults=faults)
    cfg = provider.mm_config(BACKBONES[backbone], small=small)
    task, tr0 = MMTask.create(cfg, torch.Generator().manual_seed(seed),
                              device=dev)
    return AsyncFedRun.create(task, tr0, strat, fleet, fed), ds


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=50,
                    help="logical rounds: total work = rounds * N updates")
    ap.add_argument("--dataset", default="pamap2",
                    choices=("pamap2", "mhealth"))
    ap.add_argument("--buffer", type=int, default=4,
                    help="server buffer size K (flush threshold)")
    ap.add_argument("--staleness-exp", type=float, default=0.5,
                    help="a in the 1/(1+s)^a staleness discount")
    ap.add_argument("--hetero", type=float, default=100.0,
                    help="Full/Low compute gap (paper Tables IV-V)")
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="lognormal compute-time noise sigma")
    ap.add_argument("--codec", default="none", choices=("none", "int8"),
                    help="uplink codec: int8 quantizes client deltas "
                         "(error feedback on-device, fused server ingest)")
    ap.add_argument("--backbone", default="b1", choices=tuple(BACKBONES),
                    help="b1: the CNN trained in full; b2: frozen "
                         "transformer encoders with LoRA")
    ap.add_argument("--small", action="store_true",
                    help="the reduced configuration (d_feat 16, d_fused 64; "
                         "B2: 2 encoder layers of width 32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    run, ds = build(args.dataset, args.buffer, args.staleness_exp,
                    args.hetero, args.jitter, args.codec, args.rounds,
                    args.small, args.seed, args.device, args.backbone)
    N = run.fleet.N
    print(f"[train_async_har] {args.dataset}/{args.backbone}: fleet N={N} "
          f"({args.hetero:.0f}x compute gap), G={run.task.layout.G} groups, "
          f"K={args.buffer}, a={args.staleness_exp}, codec={args.codec}, "
          f"device={args.device}")

    # synchronous FedAvg on the same fleet and device model, same total work
    f = run.fed
    sfed = FedConfig(rounds=args.rounds, local_epochs=f.local_epochs,
                     steps_per_epoch=f.steps_per_epoch,
                     batch_size=f.batch_size, lr=f.lr,
                     eval_every=max(args.rounds // 5, 1),
                     t_overhead=f.t_overhead, utilization=f.utilization,
                     seed=args.seed)
    sync = FedRun.create(run.task, run.state.trainable,
                         strategies.get("fedavg"), run.fleet, sfed)
    hs = sync.run(ds)
    sync_total = float(np.sum(hs["round_time_s"]))
    print(f"[sync fedavg ] {args.rounds} rounds in simulated "
          f"{sync_total:9.2f}s  F1 {hs['f1'][-1]:.3f}  "
          f"E {np.sum(hs['energy_j']):.0f}J")

    t0 = time.perf_counter()
    hist = run.run(ds, log_every=max(args.rounds * N // args.buffer // 10, 1))
    ups = run.trace.per_client_updates
    async_total = float(run.state.sim_time)
    print(f"[async relief] {run.state.round} flushes "
          f"({run.trace.completions} updates) in simulated "
          f"{async_total:9.2f}s  F1 {hist['f1'][-1]:.3f}  "
          f"E {run.trace.energy_j:.0f}J  host {time.perf_counter() - t0:.1f}s")
    print(f"[train_async_har] wall-clock speedup vs sync FedAvg: "
          f"{sync_total / max(async_total, 1e-12):.1f}x  (mean staleness "
          f"{np.mean(hist['staleness_mean']):.2f}, fast/slow update ratio "
          f"{ups.max()}/{max(ups.min(), 1)})")
    return hist


if __name__ == "__main__":
    main()
