"""Plain PyTorch reference of a Mixtral decoder (arXiv:2401.04088; the
``mistralai/Mixtral-8x7B-v0.1`` config.json) with one RELIEF modality-block
adapter per request, independent of the program.

Each layer: x += Wo(attn(RoPE(Wq h), RoPE(Wk h), Wv h)), h = RMSNorm(x);
x += sum over the token's top-2 experts e of g_e * W2_e(SiLU(Wg_e h) *
Wi_e h), h = RMSNorm(x), where the router's softmax over the experts picks
the two largest probabilities and g renormalises them to sum to 1. Each
expert is computed over exactly the tokens routed to it: no capacity, no
drop. Grouped-query causal attention, RoPE on the two halves of each head
(rotate-half), as ``reference/phi3.py``, whose helpers this file loads and
leaves as they are. A request's adapter adds ((h @ a) @ b) * alpha/r to the
Q and V projections and, on the fusion projection Wo, zeroes the input
columns of the absent modality blocks (one block per KV head group) before
both the base and the adapter product.

Departures from the published description, each the configuration's:
RMSNorm at eps 1e-6 (published 1e-5: the program fixes 1e-6), with weights
stored as w and scale (1 + w); the router's weights kept in fp32, as the
program keeps every router; no sliding window (published none), so the
program's 4096-token window, which never binds on its 2560-slot rings, is
left out; the adapters and fusion masks, which are RELIEF's.

``forward`` runs in fp32 with TF32 off, layer by layer, upcasting one
layer's weights at a time, and returns the logits at the asked positions
and every layer's top-2 expert ids; given the experts a program chose, it
sends each token there instead (``routes``) and still returns its own
router's choice. ``weight_precision="fp8"`` is the control one step below
the bf16 the configuration serves in: every projection and expert weight
and the head quantized to float8 e4m3 with one scale per output column (the
router keeps its fp32).
"""
from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F


def _phi3():
    """``reference/phi3.py``, loaded once under the harness's name."""
    name = "portbench_ref_phi3"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, Path(__file__).with_name("phi3.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


_P = _phi3()
padded_vocab, block_mask = _P.padded_vocab, _P.block_mask
ROUTER = ("base", "layers", "mlp", "router")  # fp32 in every dtype


def param_specs(m: dict) -> list[tuple[tuple, tuple[int, ...], float]]:
    """(path, shape, std) of the base weights, std 0 for zeros: embedding
    N(0, 0.02^2), projections, experts and the router N(0, 1/fan_in), norm
    weights 0. The router (``ROUTER``) is drawn in fp32."""
    d, L, ff = m["hidden_size"], m["num_hidden_layers"], m["intermediate_size"]
    H, K, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                m["head_dim"])
    E, V = m["num_local_experts"], padded_vocab(m["vocab_size"])
    b = ("base",)
    lay = b + ("layers",)
    return [
        (b + ("embed",), (V, d), 0.02),
        (lay + ("attn", "wq"), (L, d, H * hd), 1 / math.sqrt(d)),
        (lay + ("attn", "wk"), (L, d, K * hd), 1 / math.sqrt(d)),
        (lay + ("attn", "wv"), (L, d, K * hd), 1 / math.sqrt(d)),
        (lay + ("attn", "wo"), (L, H * hd, d), 1 / math.sqrt(H * hd)),
        (lay + ("ln1",), (L, d), 0.0),
        (lay + ("ln2",), (L, d), 0.0),
        (ROUTER, (L, d, E), 1 / math.sqrt(d)),
        (lay + ("mlp", "wg"), (L, E, d, ff), 1 / math.sqrt(d)),
        (lay + ("mlp", "wi"), (L, E, d, ff), 1 / math.sqrt(d)),
        (lay + ("mlp", "wo"), (L, E, ff, d), 1 / math.sqrt(ff)),
        (b + ("final_norm",), (d,), 0.0),
        (b + ("lm_head",), (d, V), 1 / math.sqrt(d)),
    ]


def _attention(x, wq, wk, wv, wo, lo, mask, m):
    """Causal GQA over one sequence x [S, d] with its adapter ``lo``."""
    S = x.shape[0]
    H, K, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                m["head_dim"])
    theta = m["rope_theta"]
    q = (x @ wq + lo("wq", x)).reshape(S, H, hd)
    k = (x @ wk).reshape(S, K, hd)
    v = (x @ wv + lo("wv", x)).reshape(S, K, hd)
    q, k = _P._rope(q, theta), _P._rope(k, theta)
    q = q.reshape(S, K, H // K, hd)
    s = torch.einsum("qkgh,tkh->kgqt", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("kgqt,tkh->qkgh", p, v).reshape(S, H * hd)
    om = o * mask
    return om @ wo + lo("wo", om)


def _experts(h, router, wg, wi, w2, top_k, forced=None):
    """h [S, d] -> (the gated sum of each token's top-k experts [S, d],
    the router's top-k expert ids [S, k]); each expert over the tokens
    routed to it. With ``forced`` [S, k'] the tokens go to those experts
    instead, gated by the router's probabilities of them renormalised."""
    probs = torch.softmax(h @ router, dim=-1)
    ids = torch.topk(probs, top_k, dim=-1).indices
    use = ids if forced is None else forced.to(ids.device).long()
    gates = probs.gather(-1, use)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(router.shape[1]):
        tok, slot = torch.nonzero(use == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        he = h[tok]
        ye = (F.silu(he @ wg[e]) * (he @ wi[e])) @ w2[e]
        out.index_add_(0, tok, ye * gates[tok, slot, None])
    return out, ids


@torch.no_grad()
def forward(m: dict, base: dict, seqs: list[torch.Tensor],
            adapters: list[dict], masks: list[torch.Tensor],
            positions: list[torch.Tensor], weight_precision: str = "fp32",
            routes: list[torch.Tensor] | None = None
            ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """For each sequence [S] (tokens), its adapter {target: (a [L, in, r],
    b [L, r, out])}, its [n_heads*head_dim] fusion mask and the positions
    whose next-token logits are wanted -> ([len(positions), vocab] fp32
    logits, the router's [L, S, top_k] expert ids) per sequence.
    ``routes``: per sequence [L, S, k'] expert ids that every (layer,
    token) is sent to in place of the router's own top-k (the experts a
    program under test chose), so that a routing decision taken the other
    way at a near-tie does not carry into every later layer and token.

    ``base``: flat {path: tensor} as ``param_specs`` lays it out."""
    L, eps = m["num_hidden_layers"], m["rms_norm_eps"]
    top_k, V = m["num_experts_per_tok"], m["vocab_size"]
    scale = m["lora_alpha"] / m["lora_rank"]
    q8 = _P._fp8 if weight_precision == "fp8" else (lambda w: w)
    dev = base[("base", "embed")].device
    with _P._no_tf32():
        hs = [base[("base", "embed")][s.to(dev).long()].float() for s in seqs]
        own = [[] for _ in seqs]
        for i in range(L):
            def w(*k, i=i):
                return base[("base", "layers") + k][i].float()
            wq, wk, wv, wo = (q8(w("attn", n))
                              for n in ("wq", "wk", "wv", "wo"))
            wg, wi, w2 = (torch.stack([q8(x) for x in w("mlp", n)])
                          for n in ("wg", "wi", "wo"))
            ln1, ln2, router = w("ln1"), w("ln2"), w("mlp", "router")
            for j, x in enumerate(hs):
                ad = adapters[j]

                def lo(t, h, ad=ad):
                    a, b = ad[t]
                    return (h @ a[i].float()) @ b[i].float() * scale

                x = x + _attention(_P._rmsnorm(ln1, x, eps), wq, wk, wv, wo,
                                   lo, masks[j].to(dev), m)
                y, ids = _experts(_P._rmsnorm(ln2, x, eps), router, wg, wi,
                                  w2, top_k,
                                  None if routes is None else routes[j][i])
                hs[j] = x + y
                own[j].append(ids)
            del wg, wi, w2
        fn = base[("base", "final_norm")].float()
        head = q8(base[("base", "lm_head")].float())[:, :V]
        return ([_P._rmsnorm(fn, x[pos.to(dev)], eps) @ head
                 for x, pos in zip(hs, positions)],
                [torch.stack(r) for r in own])


def logits(m: dict, base: dict, seqs, adapters, masks, positions,
           weight_precision: str = "fp32", routes=None) -> list[torch.Tensor]:
    """``forward``'s logits alone, as ``reference/phi3.py`` gives them."""
    return forward(m, base, seqs, adapters, masks, positions,
                   weight_precision, routes)[0]
