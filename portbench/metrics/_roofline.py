"""The yardstick's arithmetic: NVIDIA H100 SXM data-sheet peaks (dense, at
the 700 W limit), the bytes and operations kernels 3 and 4 need for one
call, and the model FLOPs of a B2 round and of a served token."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """Least time: the larger of bytes over HBM and flops over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def fused_bound_s(K, T, D, F, r, shared, es) -> float:
    """Kernel 3, y = (x*m) @ W0 + ((x*m) @ a) @ b * s for K stacked
    calls: each operand read once (one shared by all K once), y written
    once. fp32 runs on the tensor cores as 3xTF32 (three products per
    product, over the TF32 peak); bf16 one product over the bf16 peak."""
    k = K or 1

    def n(name):
        return 1 if (K is None or name in shared) else k

    nbytes = ((k * T * D + n("w0") * D * F + n("a") * D * r + n("b") * r * F
               + k * T * F) * es + 4 * n("mask") * D)
    flops = k * T * (2 * D * F + 2 * D * r + 2 * r * F + D + 2 * F)
    if es == 2:
        return bound_s(nbytes, flops, BF16_FLOPS_PER_S)
    return bound_s(nbytes, 3 * flops, TF32_FLOPS_PER_S)


def multi_bound_s(B, D, F, r, used, masked, es) -> float:
    """Kernel 4, the gathered projection over B rows: x, W0 and y once in
    x's type, the ``used`` adapters' fp32 a and b once, the int32 indices
    and the fp32 row masks once."""
    nbytes = ((B * D + D * F + B * F) * es + 4 * used * r * (D + F) + 4 * B
              + (4 * B * D if masked else 0))
    flops = 2 * B * D * F + 2 * B * r * (D + F) + (B * D if masked else 0)
    peak = BF16_FLOPS_PER_S if es == 2 else FP32_FLOPS_PER_S
    return bound_s(nbytes, flops, peak)


def b2_round_flops(c: dict, t: dict) -> float:
    """Model FLOPs of one round: every client's steps x batch samples, each
    the forward of everything and the backward of what is trained: the
    input gradient of every product after the frozen patch embedding and
    the weight gradient of each trained product (LoRA, fusion a and b,
    head)."""
    d, L, ff, r, P = (c["enc_d"], c["enc_layers"], c["enc_ff"],
                      c["lora_rank"], c["patch"])
    ntok = c["window"] // P
    F, hh, ncls = c["d_fused"], c["head_hidden"], c["n_classes"]
    D = sum(m["d_feat"] for m in c["modalities"])
    fwd = back = 0.0
    for m in c["modalities"]:
        patch = 2 * ntok * P * m["channels"] * d
        dense = L * ntok * (4 * 2 * d * d + 2 * 2 * ntok * d + 3 * 2 * d * ff)
        lora = L * ntok * (2 * (2 * d * r + 2 * r * d) + 2 * d * r + 2 * r * ff)
        proj = 2 * d * m["d_feat"]
        fwd += patch + dense + lora + proj
        back += dense + lora + proj + lora
    fusion, flora, head = 2 * D * F, 2 * D * r + 2 * r * F, 2 * F * hh + 2 * hh * ncls
    fwd += fusion + flora + head
    back += fusion + 2 * flora + 2 * head
    rd = t["round"]
    samples = (t["clients"] * rd["local_epochs"] * rd["steps_per_epoch"]
               * rd["batch_size"])
    return samples * (fwd + back)


def lm_flops(m: dict, tokens: int, context: int) -> float:
    """``tokens`` tokens through the served model with ``context`` keys
    attended in all: 2 x the matrix parameters (projections, adapters and
    the unembedding) per token, plus attention's 4 x n_heads x head_dim per
    key and layer."""
    d, L, ff = m["hidden_size"], m["num_hidden_layers"], m["intermediate_size"]
    H, K, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                m["head_dim"])
    per_layer = d * H * hd * 2 + 2 * d * K * hd + 3 * d * ff
    lora = sum(m["lora_rank"] * (i + o) for i, o in m["lora_targets"].values())
    return (2.0 * tokens * (L * (per_layer + lora) + d * m["vocab_size"])
            + 4.0 * L * H * hd * context)
