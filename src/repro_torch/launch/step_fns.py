"""Step functions of the serve path: prefill and one greedy decode step.
The train step is not ported yet (ROADMAP.md, port queue)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        # unembed only the final position: full-sequence logits at a 100k+
        # vocab would dominate the prefill's memory and bytes
        h, _, _ = api.forward_hidden(params, cfg, batch)
        return api.TF.unembed(params, cfg, h[:, -1:])[:, 0]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params: dict, caches: Any, token: torch.Tensor,
                   pos: Any) -> tuple:
        logits, caches = api.decode_step(params, cfg, caches, token, pos)
        return logits[:, -1:].argmax(-1).to(torch.int32), caches

    return serve_step
