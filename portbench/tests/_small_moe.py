"""A small CPU version of the MoE serving cell for the tests: the cell's
own files, with the widths cut so that a run takes seconds."""
from __future__ import annotations

import time
import types

import torch

from _small import HERE, _runner, harness


def moe(seed: int = 3_000_000_123, plant=None, seconds: float = 1.0,
        control: bool = False):
    """mixtral at the port's SMOKE widths (2 layers, d 64, 4 experts,
    top-2, fp32, no window) under an open loop of 20 requests a second on
    4 slots, on the CPU."""
    cfg = harness.read_json(HERE / "configs" / "mixtral-8x7b.json")
    cfg["model"].update(
        hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        num_local_experts=4, vocab_size=128, torch_dtype="float32",
        lora_targets={"wq": [64, 64], "wv": [64, 32], "wo": [64, 64]})
    cfg["port"] = {"arch": "mixtral-8x7b", "preset": "SMOKE",
                   "overrides": {"moe_impl": "dropless", "vocab": 128,
                                 "rope_theta": 1e6, "layer_pattern": "global",
                                 "sliding_window": None}}
    tr = harness.read_json(HERE / "traffic" / "open-moe64.json")
    tr.update(warm_requests=4, arrival={"rate_per_s": 20.0}, batch_slots=4,
              max_len=64, adapters=6, pool=64,
              strata=8, prompt={"lo": 4, "hi": 24},
              output={"lo": 2, "hi": 16}, warm_steps=2, check_requests=3)
    ctx = types.SimpleNamespace(
        seed=seed, seconds=seconds, trace=False, t0=time.perf_counter(),
        device=torch.device("cpu"), chips=1, config=cfg, traffic=tr,
        plant=plant, control=control)
    return ctx, _runner(tr["kind"])
