"""Small CPU versions of the benchmark's cells for the tests: the cell's own
files, with the widths and the fleet cut so that a run takes seconds."""
from __future__ import annotations

import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

import harness  # noqa: E402


def _runner(kind: str):
    return harness.load_module(HERE / "runners" / f"{kind}.py",
                               f"portbench_runner_{kind}")


def har(seed: int = 3_000_000_123, plant=None, seconds: float = 0.5):
    """PAMAP2 B2 at the port's PAMAP2_B2_SMALL widths, 8 clients, one
    local epoch, on the CPU."""
    cfg = harness.read_json(HERE / "configs" / "pamap2-b2.json")
    m = cfg["model"]
    for mo in m["modalities"]:
        mo["d_feat"] //= 2
    m.update(enc_layers=2, enc_d=32, enc_ff=64, d_fused=64)
    tr = harness.read_json(HERE / "traffic" / "relief-n100.json")
    tr["clients"] = 8
    tr["round"]["local_epochs"] = 1
    ctx = types.SimpleNamespace(
        seed=seed, seconds=seconds, trace=False, t0=time.perf_counter(),
        device=torch.device("cpu"), chips=1, config=cfg, traffic=tr,
        plant=plant, control=False)
    return ctx, _runner("fed_round")


def lm(seed: int = 3_000_000_123, plant=None, seconds: float = 1.0,
       control: bool = False):
    """phi3 at the port's SMOKE widths (2 layers, d 64, fp32) under an
    open loop of 20 requests a second on 4 slots, on the CPU."""
    cfg = harness.read_json(HERE / "configs" / "phi3-medium-14b.json")
    cfg["model"].update(
        hidden_size=64, intermediate_size=160, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        vocab_size=128, torch_dtype="float32",
        lora_targets={"wq": [64, 64], "wv": [64, 32], "wo": [64, 64]})
    cfg["port"] = {"arch": "phi3-medium-14b", "preset": "SMOKE",
                   "overrides": {}}
    tr = harness.read_json(HERE / "traffic" / "open-zipf64.json")
    tr.update(warm_requests=4, arrival={"rate_per_s": 20.0}, batch_slots=4,
              max_len=64, adapters=6, pool=64,
              strata=8, prompt={"lo": 4, "hi": 24},
              output={"lo": 2, "hi": 16}, warm_steps=2, check_requests=3)
    ctx = types.SimpleNamespace(
        seed=seed, seconds=seconds, trace=False, t0=time.perf_counter(),
        device=torch.device("cpu"), chips=1, config=cfg, traffic=tr,
        plant=plant, control=control)
    return ctx, _runner("engine_loop")


def limits(workload: str) -> dict:
    return harness.read_json(HERE / "limits" / f"{workload}.json")
