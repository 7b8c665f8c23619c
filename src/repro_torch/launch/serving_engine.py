"""Batched multi-LoRA personalized serving engine.

RELIEF personalizes one modality-block LoRA adapter per client; at traffic
each request carries its own adapter and modality mask. Serving them one
model at a time re-runs the whole base model at batch 1 per request. This
engine instead:

* keeps client adapters in an ``AdapterRegistry`` -- one [L, A, din, r]
  stacked store per LoRA target -- with no per-request weight copies and no
  merge step;
* runs continuous batching: requests join and leave the decode batch at
  step granularity. Admission prefills the prompt into a clone of a fresh
  single-row cache and copies that row into the shared per-row-position
  cache, so a new request never perturbs the rows already mid-stream;
* decodes the whole mixed batch with one gathered projection per LoRA
  target (``kernels/mdlora.mdlora_matmul_multi``): each row's
  ``adapter_idx`` picks its adapter inside the kernel and per-row fusion
  masks zero absent-modality blocks.

A request's prompt is [P] text tokens: a vlm request is text only (no
patches), and a codebook config (musicgen) raises, as the reference's
engine cannot take its [P, n_codebooks] prompts. ``naive_serve`` is the
baseline: sequential per-request decode with the
request's single adapter. The engine's attention takes per-row positions,
so it runs the plain chunked attention, as the reference's does. An MoE
model's expert layers run as its config's ``moe_impl`` says, at admission
and at decode alike: "dropless" (``models/moe.py``: the batch's
assignments grouped by expert, none dropped) serves the model as
published; "sparse", the training path, drops assignments past its
capacity per (sequence, expert) and gives a decode row 2 slots per expert.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import runtime
from repro_torch.kernels.mdlora import block_row_mask
from repro_torch.models import api
from repro_torch.models import transformer as TF
from repro_torch.tree import tree_map


@dataclasses.dataclass
class Request:
    rid: str
    prompt: np.ndarray  # [P] int tokens
    adapter: str  # registry name
    max_new_tokens: int = 16
    submit_t: float = 0.0


def _clone(tree: Any) -> Any:
    return tree_map(torch.clone, tree)


def _greedy(logits: torch.Tensor) -> np.ndarray:
    """[B, 1, V] logits -> [B] greedy token ids on the host."""
    return logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()


# ---------------------------------------------------------------------------
# adapter registry
# ---------------------------------------------------------------------------


class AdapterRegistry:
    """Capacity-slotted store of per-client MDLoRA adapters.

    ``store`` has the tree of ``params["lora"]`` with leaves stacked
    [L, capacity, din, r], so each layer's slice is the [A, din, r] store
    the gathered kernel reads. Registration writes one
    slot; eviction frees it (zeroed: an empty slot is the base model).
    ``ingest_update`` adds a server-side delta ([L, din, r] leaves, e.g. an
    aggregate) to a registered adapter in place: the next decode step sees
    it without any repacking.
    """

    def __init__(self, cfg: ModelConfig, capacity: int,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.capacity = capacity
        self.device = runtime.resolve_device(device)
        dt, n, r = TF.lora_dtype(cfg), cfg.n_layers, cfg.lora_rank
        self.store = {"layers": {
            name: {"a": torch.zeros((n, capacity, din, r), dtype=dt,
                                    device=self.device),
                   "b": torch.zeros((n, capacity, r, dout), dtype=dt,
                                    device=self.device)}
            for name, (din, dout) in api.lora_shapes(cfg).items()}}
        self.block_dims = api.fusion_block_dims(cfg)
        self.fusion_masks = torch.ones((capacity, sum(self.block_dims)),
                                       device=self.device)
        self._slots: dict[str, int] = {}
        self._free = list(range(capacity))

    def slot(self, name: str) -> int:
        return self._slots[name]

    def register(self, name: str, lora_tree: Any,
                 modality_mask=None) -> int:
        """lora_tree: [L, din, r]-leaf adapter (e.g. params["lora"]);
        modality_mask: [M] availability over ``api.fusion_block_dims``."""
        if name in self._slots:
            s = self._slots[name]
        else:
            if not self._free:
                raise RuntimeError("adapter registry full")
            s = self._free.pop(0)
            self._slots[name] = s
        tree_map(lambda big, leaf: big[:, s].copy_(leaf), self.store,
                 lora_tree)
        if modality_mask is None:
            self.fusion_masks[s] = 1.0
        else:
            self.fusion_masks[s].copy_(
                block_row_mask(self.block_dims, modality_mask))
        return s

    def ingest_update(self, name: str, delta_tree: Any,
                      server_lr: float = 1.0) -> None:
        s = self._slots[name]
        tree_map(lambda big, d: big[:, s].add_(
                     server_lr * d.to(big.device, big.dtype)),
                 self.store, delta_tree)

    def evict(self, name: str) -> None:
        s = self._slots.pop(name)
        tree_map(lambda big: big[:, s].zero_(), self.store)
        self.fusion_masks[s] = 1.0
        self._free.append(s)

    def lora_view(self, name: str) -> Any:
        """Single-adapter [L, din, r] tree (naive baseline / admission)."""
        s = self._slots[name]
        return tree_map(lambda big: big[:, s], self.store)


# ---------------------------------------------------------------------------
# continuous-batching engine
# ---------------------------------------------------------------------------


class ServingEngine:
    """Continuous-batching decode loop over ``batch_slots`` cache rows.

    Every step: (1) free slots are filled from the queue -- the prompt is
    prefilled into a fresh single-row cache and the row is copied into the
    shared cache; (2) one batched decode step advances all rows, each
    applying its own adapter through the gathered projection. Finished rows
    are recycled at once. ``lora_impl="pallas"`` takes the op in
    ``kernels/mdlora`` (the CUDA kernel on the card), "xla" its plain
    version.
    """

    def __init__(self, params: dict, cfg: ModelConfig,
                 registry: AdapterRegistry, batch_slots: int, max_len: int,
                 lora_impl: str = "xla"):
        if cfg.n_codebooks:
            raise ValueError(
                f"{cfg.arch}: the serving engine takes no codebook prompts "
                "([S, n_codebooks]), as the reference's engine takes none; "
                "serve it with serve.run_batched")
        self.cfg = cfg
        self.registry = registry
        self.device = registry.device
        self.B = batch_slots
        self.max_len = max_len
        self.lora_impl = lora_impl
        self.params = {"base": params["base"]}
        self.caches = api.init_caches(cfg, batch_slots, max_len,
                                      per_row_pos=True, device=self.device)
        self.queue: list[Request] = []
        # per-slot host state
        self.active = np.zeros(batch_slots, bool)
        self.pos = np.zeros(batch_slots, np.int32)
        self.remaining = np.zeros(batch_slots, np.int32)
        self.adapter_idx = np.zeros(batch_slots, np.int32)
        self.requests: list[Request | None] = [None] * batch_slots
        self.cur = np.zeros((batch_slots, 1), np.int32)
        self.outputs: dict[str, list[int]] = {}
        self.latency: dict[str, float] = {}
        self.step_times: list[float] = []
        # zeroed single-row cache; every admission prefills a clone of it
        # (caches are written in place)
        self._fresh_row = api.init_caches(cfg, 1, max_len, per_row_pos=True,
                                          device=self.device)

    def submit(self, req: Request) -> None:
        req.submit_t = time.perf_counter()
        self.queue.append(req)
        self.outputs[req.rid] = []

    # -- admission ---------------------------------------------------------

    def _admit(self, slot: int, req: Request) -> None:
        with trace.span("engine.admit") as sp:
            if sp is not trace.OFF:
                sp.attrs.update(rid=req.rid, prompt_len=len(req.prompt),
                                adapter=req.adapter)
            aslot = self.registry.slot(req.adapter)
            with trace.span("admit.prefill"):
                tokens = torch.as_tensor(np.asarray(req.prompt),
                                         dtype=torch.int32,
                                         device=self.device)[None]
                lora = tree_map(lambda x: x[:, aslot], self.registry.store)
                logits, small = api.prefill_with_cache(
                    {"base": self.params["base"], "lora": lora},
                    self.cfg, _clone(self._fresh_row), tokens,
                    fusion_mask=self.registry.fusion_masks[aslot][None])
                # the fresh row overwrites the whole slot (pos = -1 past the
                # prompt; the conv and SSM states of a recurrent family
                # too), so a recycled slot keeps nothing of its last occupant
                tree_map(lambda big, row: big[:, slot].copy_(row[:, 0]),
                         self.caches, small)
            with trace.wait("admit.first_token"):
                first = int(_greedy(logits)[0])
            self.active[slot] = True
            self.pos[slot] = len(req.prompt)
            self.remaining[slot] = req.max_new_tokens
            self.adapter_idx[slot] = aslot
            self.requests[slot] = req
            self.cur[slot, 0] = first
            self.outputs[req.rid].append(first)
            self.remaining[slot] -= 1
            if self.remaining[slot] <= 0:
                self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self.requests[slot]
        self.latency[req.rid] = time.perf_counter() - req.submit_t
        self.active[slot] = False
        self.requests[slot] = None

    # -- decode loop -------------------------------------------------------

    def _decode(self) -> np.ndarray:
        dev = self.device
        with trace.span("decode.issue"):
            aidx = torch.as_tensor(self.adapter_idx, device=dev)
            logits, self.caches = api.decode_step(
                {"base": self.params["base"], "lora": self.registry.store},
                self.cfg, self.caches, torch.as_tensor(self.cur, device=dev),
                torch.as_tensor(self.pos, device=dev), adapter_idx=aidx,
                fusion_mask=self.registry.fusion_masks[aidx],
                lora_impl=self.lora_impl)
        with trace.wait("decode.next_tokens"):
            return _greedy(logits)

    def step(self) -> int:
        """Admit what fits, run one batched decode step; -> #active rows."""
        with trace.span("engine.step"):
            for slot in range(self.B):
                if not self.active[slot] and self.queue:
                    self._admit(slot, self.queue.pop(0))
            if not self.active.any():
                return 0
            t0 = time.perf_counter()
            with trace.span("engine.decode") as sp:
                if sp is not trace.OFF:
                    sp.attrs["rows"] = int(self.active.sum())
                nxt = self._decode()  # on the host: the step has finished
            self.step_times.append(time.perf_counter() - t0)
            for slot in range(self.B):
                if not self.active[slot]:
                    continue
                self.pos[slot] += 1
                self.cur[slot, 0] = nxt[slot]
                self.outputs[self.requests[slot].rid].append(int(nxt[slot]))
                self.remaining[slot] -= 1
                if (self.remaining[slot] <= 0
                        or self.pos[slot] >= self.max_len - 1):
                    self._retire(slot)
            return int(self.active.sum())

    def run(self) -> dict:
        """Drain queue + active rows; -> outputs and timing stats."""
        t0 = time.perf_counter()
        n_steps = 0
        while self.queue or self.active.any():
            self.step()
            n_steps += 1
        wall = time.perf_counter() - t0
        n_tok = sum(len(v) for v in self.outputs.values())
        lat = sorted(self.latency.values()) or [0.0]
        return {
            "outputs": dict(self.outputs),
            "n_steps": n_steps,
            "wall_s": wall,
            "generated_tokens": n_tok,
            "tok_s": n_tok / max(wall, 1e-9),
            "latency_p50_s": lat[len(lat) // 2],
            "latency_p99_s": lat[min(len(lat) - 1,
                                     int(np.ceil(0.99 * len(lat))) - 1)],
            "decode_step_times": list(self.step_times),
        }


# ---------------------------------------------------------------------------
# naive baseline: one single-adapter model per request, sequential
# ---------------------------------------------------------------------------


def naive_serve(params: dict, cfg: ModelConfig, registry: AdapterRegistry,
                requests: list[Request], max_len: int) -> dict:
    """Per-request decode with the request's single adapter -- what serving
    N personalized clients costs without the gathered batched path."""
    dev = registry.device
    fresh = api.init_caches(cfg, 1, max_len, device=dev)
    outputs: dict[str, list[int]] = {}
    t0 = time.perf_counter()
    for req in requests:
        aslot = registry.slot(req.adapter)
        p = {"base": params["base"], "lora": registry.lora_view(req.adapter)}
        fmask = registry.fusion_masks[aslot][None]
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                                 device=dev)[None]
        logits, caches = api.prefill_with_cache(p, cfg, _clone(fresh), tokens,
                                                fusion_mask=fmask)
        toks = [int(_greedy(logits)[0])]
        pos = len(req.prompt)
        while len(toks) < req.max_new_tokens and pos < max_len - 1:
            cur = torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)
            logits, caches = api.decode_step(p, cfg, caches, cur, pos,
                                             fusion_mask=fmask)
            toks.append(int(_greedy(logits)[0]))
            pos += 1
        outputs[req.rid] = toks
    wall = time.perf_counter() - t0
    n_tok = sum(len(v) for v in outputs.values())
    return {"outputs": outputs, "wall_s": wall, "generated_tokens": n_tok,
            "tok_s": n_tok / max(wall, 1e-9)}
