"""The CUDA kernels (cohort aggregation, flash attention, the fused and
the gathered block-LoRA projections, the SSD scan) against their plain
PyTorch versions, on the card. Marked
``cuda``: each test skips without a card, and the file imports no JAX so it
runs on a machine that has only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.cohort_agg import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.mdlora import ops as md_ops  # noqa: E402
from repro_torch.kernels.mdlora import ref as md_ref  # noqa: E402
from repro_torch.kernels.mdlora.autograd import fused_block_lora  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

pytestmark = pytest.mark.cuda

# fp32 sums over N clients in another order than the plain einsum
ATOL = RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsum
    return torch.device("cuda")


def _inputs(N, D, r, seed, dev, empty=False):
    g = np.random.default_rng(seed)
    W = (g.random((N, D)) * (g.random((N, D)) < 0.7)).astype(np.float32)
    C = (g.random((N, D)) < 0.6).astype(np.float32)
    if empty:
        W[:] = 0.0
        C[:] = 0.0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (t(g.normal(size=(N, D, r)).astype(np.float32)), t(W), t(C),
            t(g.integers(-127, 128, (N, D, r)).astype(np.int8)),
            t(g.uniform(1e-3, 1e-1, N).astype(np.float32)),
            t(g.integers(0, 6, N).astype(np.float32)))


SHAPES = [(4, 64, 4), (9, 128, 8), (16, 256, 1), (9, 96, 8), (16, 100, 1),
          (4, 112, 128), (300, 100, 1)]


@pytest.mark.parametrize("N,D,r", SHAPES)
@pytest.mark.parametrize("empty", [False, True], ids=["cohort", "empty"])
def test_fp32_kernel_matches_plain(dev, N, D, r, empty):
    x, W, C, *_ = _inputs(N, D, r, N * D + r, dev, empty)
    before = ops.LAUNCHES["cohort_agg_divergence"]
    got = ops.cohort_agg_divergence(x, W, C)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cohort_agg_divergence"] == before + 1
    for a, b in zip(got, ref.cohort_agg_divergence_ref(x, W, C)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("N,D,r", SHAPES)
@pytest.mark.parametrize("exponent", [0.0, 0.5])
def test_quant_kernel_matches_plain(dev, N, D, r, exponent):
    _, W, C, q, s, st = _inputs(N, D, r, N + D + r, dev)
    before = ops.LAUNCHES["cohort_agg_divergence_quant"]
    got = ops.cohort_agg_divergence_quant(q, s, W, C, st, exponent)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cohort_agg_divergence_quant"] == before + 1
    want = ref.cohort_agg_divergence_quant_ref(q, s, W, C, st, exponent)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


def test_kernel_is_deterministic(dev):
    x, W, C, *_ = _inputs(4096, 112, 4, 0, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert ops.plan_agg(4096, 112, 4, sms).splits > 1  # the last-block sum
    a = ops.cohort_agg_divergence(x, W, C)
    b = ops.cohort_agg_divergence(x, W, C)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, W, C, q, s, st = _inputs(4, 16, 2, 0, dev)
    with pytest.raises(TypeError):
        ops.cohort_agg_divergence(x.double(), W, C)
    with pytest.raises(ValueError, match="contiguous"):
        ops.cohort_agg_divergence(x.transpose(1, 2).contiguous()
                                  .transpose(1, 2), W, C)
    with pytest.raises(ValueError, match="shape"):
        ops.cohort_agg_divergence(x, W[:, :8].contiguous(), C)
    with pytest.raises(ValueError, match="is on"):
        ops.cohort_agg_divergence(x, W.cpu(), C)
    with pytest.raises(TypeError):
        ops.cohort_agg_divergence_quant(q.float(), s, W, C, st, 0.5)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# fp32: the kernel's dot products and softmax run in another order than the
# plain einsums; bf16: the output is rounded to bf16 (2^-8 relative)
FA_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _fa_inputs(B, S, T, K, G, hd, dtype, dev, seed, filled=None, qpos=None):
    g = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    q = t(g.normal(size=(B, S, K, G, hd)).astype(np.float32)).to(dtype)
    k = t(g.normal(size=(B, T, K, hd)).astype(np.float32)).to(dtype)
    v = t(g.normal(size=(B, T, K, hd)).astype(np.float32)).to(dtype)
    filled = T if filled is None else filled
    kv = np.where(np.arange(T) < filled, np.arange(T), -1).astype(np.int32)
    g.shuffle(kv)
    if qpos is None:
        qpos = np.arange(filled - S, filled, dtype=np.int32)
    return q, k, v, t(np.asarray(qpos, np.int32)), t(kv)


FA_CASES = [  # B, S, T, K, G, hd, filled, window, softcap
    (2, 64, 64, 2, 2, 16, None, None, None),      # prefill, small
    (2, 37, 50, 2, 3, 40, 45, 16, 30.0),          # ragged S/T, window, cap
    (1, 1, 97, 1, 8, 256, 60, None, None),        # decode, hd 256
    (8, 1, 544, 10, 4, 128, 300, None, None),     # phi3 decode, ring
    (2, 512, 544, 10, 4, 128, 512, None, None),   # phi3 prefill
    (1, 300, 300, 2, 1, 64, None, 2**31 - 1, 50.0),
    (2, 9, 70, 1, 5, 18, 66, 40, None),           # hd not a multiple of 4
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,T,K,G,hd,filled,window,softcap", FA_CASES)
def test_flash_kernel_matches_plain(dev, dtype, B, S, T, K, G, hd, filled,
                                    window, softcap):
    q, k, v, qp, kp = _fa_inputs(B, S, T, K, G, hd, dtype, dev,
                                 B + S + T + hd, filled)
    before = fa_ops.LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, qp, kp, window, softcap)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1
    want = fa_ref.flash_attention_ref(q, k, v, qp, kp, window, softcap)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FA_ATOL[dtype], rtol=0)


def test_flash_kernel_empty_rows_give_zero(dev):
    q, k, v, qp, kp = _fa_inputs(2, 8, 45, 2, 2, 64, torch.float32, dev, 3,
                                 filled=20,
                                 qpos=[-1, 0, 3, 12, 19, 30, 40, 100])
    kp = torch.where(kp >= 0, kp + 4, kp)  # cached positions 4..23
    got = fa_ops.flash_attention(q, k, v, qp, kp, 8, None)
    want = fa_ref.flash_attention_ref(q, k, v, qp, kp, 8, None)
    torch.testing.assert_close(got, want, atol=FA_ATOL[torch.float32],
                               rtol=0)
    empty = ~fa_ref.attention_mask(qp, kp, 8).any(-1)
    assert empty.tolist() == [True, True, True, False, False, False, True,
                              True]
    assert (got[:, empty] == 0).all() and (got[:, ~empty] != 0).any()


def test_flash_kernel_is_deterministic(dev):
    args = _fa_inputs(2, 128, 160, 2, 4, 128, torch.bfloat16, dev, 1)
    assert torch.equal(fa_ops.flash_attention(*args),
                       fa_ops.flash_attention(*args))


BF16_CASES = [  # B, S, T, K, G, hd, filled, window, softcap
    (2, 100, 128, 5, 5, 64, 120, 1024, None),     # hymba prefill
    (3, 1, 200, 5, 5, 64, 150, 1024, None),       # hymba decode
    (1, 64, 4160, 16, 2, 128, None, 4096, 50.0),  # gemma2-27b prefill
    (2, 1, 4160, 16, 2, 128, 4150, 4096, 50.0),   # gemma2-27b decode
    (1, 40, 300, 2, 2, 256, 280, None, None),     # prefill, hd 256
    (2, 4, 300, 3, 4, 128, 250, None, None),      # S*G = 16: decode
    (2, 5, 300, 3, 4, 128, 250, None, None),      # S*G = 20: prefill
    (2, 1, 300, 3, 17, 32, 250, 100, None),       # S*G = 17: prefill
]


@pytest.mark.parametrize("B,S,T,K,G,hd,filled,window,softcap", BF16_CASES)
def test_flash_bf16_kernel_at_model_layouts(dev, B, S, T, K, G, hd, filled,
                                           window, softcap):
    """bf16 at hymba's and gemma2-27b's head layouts, hd 256, and S*G on
    both sides of the prefill/decode threshold; the call takes the path
    its S*G selects."""
    q, k, v, qp, kp = _fa_inputs(B, S, T, K, G, hd, torch.bfloat16, dev,
                                 B + S + T + hd, filled)
    path = "decode" if S * G <= fa_ops.DECODE_ROWS else "prefill"
    before = dict(fa_ops.PATH_LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, qp, kp, window, softcap)
    torch.cuda.synchronize()
    assert fa_ops.PATH_LAUNCHES[path] == before[path] + 1
    want = fa_ref.flash_attention_ref(q, k, v, qp, kp, window, softcap)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FA_ATOL[torch.bfloat16], rtol=0)


@pytest.mark.parametrize("G", [2, 4], ids=["decode", "prefill"])
def test_flash_bf16_empty_rows_give_zero(dev, G):
    q, k, v, qp, kp = _fa_inputs(2, 8, 45, 2, G, 64, torch.bfloat16, dev, 3,
                                 filled=20,
                                 qpos=[-1, 0, 3, 12, 19, 30, 40, 100])
    kp = torch.where(kp >= 0, kp + 4, kp)  # cached positions 4..23
    got = fa_ops.flash_attention(q, k, v, qp, kp, 8, None)
    want = fa_ref.flash_attention_ref(q, k, v, qp, kp, 8, None)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FA_ATOL[torch.bfloat16], rtol=0)
    empty = ~fa_ref.attention_mask(qp, kp, 8).any(-1)
    assert (got[:, empty] == 0).all() and (got[:, ~empty] != 0).any()


@pytest.mark.parametrize("T", [97, 200, 544, 2000, 6000])
def test_flash_split_kernel_matches_split_plain(dev, T):
    """The split-KV decode against the plain split-KV algorithm at the
    planner's chunk count (1, 2, 3, 11 and 32 chunks here), and against
    the one-pass plain version."""
    q, k, v, qp, kp = _fa_inputs(4, 1, T, 3, 4, 128, torch.bfloat16, dev,
                                 T, T - 16)
    n_split = fa_ops.plan_splits(q.shape, T)
    got = fa_ops.flash_attention(q, k, v, qp, kp, 300, None)
    split = fa_ref.flash_attention_split_ref(q, k, v, qp, kp, 300, None,
                                             n_split)
    torch.testing.assert_close(got.float(), split.float(),
                               atol=FA_ATOL[torch.bfloat16], rtol=0)
    want = fa_ref.flash_attention_ref(q, k, v, qp, kp, 300, None)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FA_ATOL[torch.bfloat16], rtol=0)


def test_flash_decode_is_deterministic_and_batch_invariant(dev):
    """Decode rows are bitwise repeatable, and a row's bits are the same
    at B=1 as at B=8 (the chunk count reads T and S*G only)."""
    q, k, v, qp, kp = _fa_inputs(8, 1, 544, 10, 4, 128, torch.bfloat16, dev,
                                 7, 528)
    got = fa_ops.flash_attention(q, k, v, qp, kp)
    assert torch.equal(got, fa_ops.flash_attention(q, k, v, qp, kp))
    for i in (0, 5):
        one = fa_ops.flash_attention(q[i:i + 1].contiguous(),
                                     k[i:i + 1].contiguous(),
                                     v[i:i + 1].contiguous(), qp, kp)
        assert torch.equal(one, got[i:i + 1])


# ---------------------------------------------------------------------------
# gathered multi-LoRA
# ---------------------------------------------------------------------------

# fp32 sums over D in another order; bf16: x, W0 and the output are bf16
MD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2e-2)}


def _md_inputs(B, D, F, r, A, dtype, dev, seed, blocks=2, dims=None):
    g = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    x = t(g.normal(size=(B, D)).astype(np.float32)).to(dtype)
    w0 = t((g.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)).to(dtype)
    a = t((g.normal(size=(A, D, r)) / np.sqrt(D)).astype(np.float32))
    b = t((0.05 * g.normal(size=(A, r, F))).astype(np.float32))
    idx = t(g.integers(0, A, B).astype(np.int32))
    dims = [D // blocks] * blocks if dims is None else dims
    mm = (g.random((B, len(dims))) < 0.7).astype(np.float32)
    mask = md_ops.block_row_masks(dims, mm).to(dev)
    return x, w0, a, b, idx, mask


MD_CASES = [  # B, D, F, r, A
    (8, 64, 128, 4, 3), (16, 128, 64, 8, 16), (5, 300, 77, 16, 2),
    (33, 512, 96, 8, 4),  # more rows than one pass of 16
    (16, 5120, 5120, 8, 16), (16, 5120, 1280, 8, 16),  # phi3 wq/wo, wv
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,D,F,r,A", MD_CASES)
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
def test_mdlora_kernel_matches_plain(dev, dtype, B, D, F, r, A, masked):
    x, w0, a, b, idx, mask = _md_inputs(B, D, F, r, A, dtype, dev, B + D + F)
    mask = mask if masked else None
    before = md_ops.LAUNCHES["mdlora_matmul_multi"]
    got = md_ops.mdlora_matmul_multi(x, w0, a, b, idx, mask, 2.0)
    torch.cuda.synchronize()
    assert md_ops.LAUNCHES["mdlora_matmul_multi"] == before + 1
    want = md_ref.mdlora_matmul_multi_ref(x, w0, a, b, idx, mask, 2.0)
    atol, rtol = MD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D,F,dims", [
    (1600, 1600, None), (1600, 320, None),  # hymba wq, wv: no mask
    (4800, 1600, [1600, 3200]),  # hymba's fusion wo: the block edge at
    (4800, 1600, [1700, 3100]),  # 1600 or 1700 cuts a 256-wide chunk
], ids=["wq", "wv", "wo", "wo_offset"])
def test_mdlora_kernel_at_hymba_shapes(dev, dtype, D, F, dims):
    x, w0, a, b, idx, mask = _md_inputs(16, D, F, 8, 16, dtype, dev, D + F,
                                        dims=dims or [D])
    mask = mask if dims else None
    got = md_ops.mdlora_matmul_multi(x, w0, a, b, idx, mask, 2.0)
    want = md_ref.mdlora_matmul_multi_ref(x, w0, a, b, idx, mask, 2.0)
    atol, rtol = MD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if dims:  # an absent block contributes nothing, to the last column
        cut = torch.zeros_like(x)
        cut[:, :dims[0]] = x[:, :dims[0]]
        one = torch.zeros_like(mask)
        one[:, :dims[0]] = 1.0
        torch.testing.assert_close(
            md_ops.mdlora_matmul_multi(x, w0, a, b, idx, one, 2.0),
            md_ops.mdlora_matmul_multi(cut, w0, a, b, idx, one, 2.0),
            atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,D,F", [(16, 512, 256), (16, 5120, 1280)])
def test_mdlora_kernel_rows_are_batch_invariant(dev, dtype, B, D, F):
    """Bitwise: a row alone equals that row in the batch, and a permuted
    batch gives the permuted rows."""
    x, w0, a, b, idx, mask = _md_inputs(B, D, F, 8, 6, dtype, dev, 11)
    full = md_ops.mdlora_matmul_multi(x, w0, a, b, idx, mask, 2.0)
    for i in (0, 7, B - 1):
        one = md_ops.mdlora_matmul_multi(x[i:i + 1], w0, a, b, idx[i:i + 1],
                                         mask[i:i + 1], 2.0)
        assert torch.equal(one[0], full[i])
    perm = torch.as_tensor(np.random.default_rng(0).permutation(B),
                           device=dev)
    yp = md_ops.mdlora_matmul_multi(x[perm].contiguous(), w0, a, b,
                                    idx[perm].contiguous(),
                                    mask[perm].contiguous(), 2.0)
    assert torch.equal(yp, full[perm])


# the fused projection, one adapter for every row (TPU kernel 3)

def _fused_inputs(K, T, D, F, r, dtype, dev, seed, share=("w0",)):
    """x [K, T, D], W0 [D, F], a [K, D, r], b [K, r, F], mask [K, D]; the
    operands named in ``share`` lose their batch axis (stride 0)."""
    g = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
    ops = {"x": t(g.normal(size=(K, T, D))),
           "w0": t(g.normal(size=(K, D, F)) / np.sqrt(D)),
           "a": t(g.normal(size=(K, D, r)) / np.sqrt(D)),
           "b": t(0.3 * g.normal(size=(K, r, F)))}
    blocks = [D // 4] * 3 + [D - 3 * (D // 4)]
    mm = (g.random((K, 4)) < 0.6).astype(np.float32)
    mm[:, 0] = 1.0
    ops["mask"] = t(np.repeat(mm, blocks, axis=1))
    for name in share:
        ops[name] = ops[name][0].contiguous()
    return tuple(v.to(dtype) if k != "mask" else v for k, v in ops.items()) \
        + (2.0,)


FUSED_CASES = [  # K, T, D, F, r, shared operands
    (8, 32, 112, 128, 8, ("w0",)),  # the training path: 8 clients, W0 frozen
    (1, 256, 112, 128, 8, ("w0", "a", "b", "mask")),  # an evaluation batch
    (3, 37, 100, 70, 5, ("w0",)),  # ragged T, D, F
    (5, 65, 33, 130, 64, ()),  # every operand batched, the largest rank
    (4, 16, 64, 64, 1, ("a", "b")),  # adapters shared, W0 batched
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("K,T,D,F,r,share", FUSED_CASES)
def test_fused_mdlora_kernel_matches_plain(dev, dtype, K, T, D, F, r, share):
    args = _fused_inputs(K, T, D, F, r, dtype, dev, K + T + D, share)
    before = md_ops.LAUNCHES["mdlora_matmul"]
    got = md_ops.mdlora_matmul(*args)
    torch.cuda.synchronize()
    assert md_ops.LAUNCHES["mdlora_matmul"] == before + 1
    want = md_ref.mdlora_matmul_ref(*args)
    assert got.dtype == dtype and got.shape == want.shape
    atol, rtol = MD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    again = md_ops.mdlora_matmul(*args)  # fixed order, no atomics
    assert torch.equal(got, again)


def test_fused_mdlora_kernel_unbatched_and_masked_rows(dev):
    """2-D operands give [T, F]; absent rows poisoned with 1e4 do not reach
    y (bitwise: the product of a zeroed row is exactly 0)."""
    x, w0, a, b, mask, s = _fused_inputs(1, 40, 112, 128, 8, torch.float32,
                                         dev, 3, ("x", "w0", "a", "b",
                                                  "mask"))
    y = md_ops.mdlora_matmul(x, w0, a, b, mask, s)
    assert y.shape == (40, 128)
    torch.testing.assert_close(y, md_ref.mdlora_matmul_ref(x, w0, a, b, mask,
                                                           s),
                               atol=1e-4, rtol=1e-4)
    poisoned = x + (1.0 - mask) * 1e4
    assert torch.equal(md_ops.mdlora_matmul(poisoned, w0, a, b, mask, s), y)


def test_fused_mdlora_backward_on_card_matches_cpu(dev):
    """vmap(grad) over 8 clients through the autograd Function: the card
    (one kernel launch per forward, PyTorch backward) against the CPU
    (plain version), fp32 to 1e-4; absent rows of da exactly 0 on both."""
    x, w0, a, b, mask, s = _fused_inputs(8, 32, 112, 128, 8, torch.float32,
                                         "cpu", 4)

    def grads(dv):
        def loss(a_, b_, x_, m_):
            y = fused_block_lora(x_, w0.to(dv), a_, b_, m_, s)
            return torch.tanh(y).square().sum()
        return torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
            a.to(dv), b.to(dv), x.to(dv), mask.to(dv))

    before = md_ops.LAUNCHES["mdlora_matmul"]
    card = grads(dev)
    torch.cuda.synchronize()
    assert md_ops.LAUNCHES["mdlora_matmul"] == before + 1
    for name, g_card, g_cpu in zip(("da", "db", "dx"), card, grads("cpu")):
        torch.testing.assert_close(g_card.cpu(), g_cpu, atol=1e-4, rtol=1e-4,
                                   msg=name)
    assert (card[0][mask.to(dev) == 0] == 0).all()


def test_fused_mdlora_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, w0, a, b, mask, s = _fused_inputs(2, 8, 32, 16, 4, torch.float32,
                                         dev, 0)
    with pytest.raises(TypeError):
        md_ops.mdlora_matmul(x, w0.bfloat16(), a, b, mask, s)
    with pytest.raises(TypeError):
        md_ops.mdlora_matmul(x, w0, a, b, mask.bfloat16(), s)
    with pytest.raises(ValueError, match="contiguous"):
        md_ops.mdlora_matmul(x, w0.t().contiguous().t(), a, b, mask, s)
    with pytest.raises(ValueError, match="batch axes"):
        md_ops.mdlora_matmul(x, w0, a[:1].contiguous(), b, mask, s)
    with pytest.raises(ValueError, match="unsupported"):
        md_ops.mdlora_matmul(*_fused_inputs(1, 8, 32, 16, 65, torch.float32,
                                            dev, 0))
    with pytest.raises(ValueError, match="shape"):
        md_ops.mdlora_matmul(x, w0, a, b, mask[:, :31].contiguous(), s)


def test_cpu_tensors_never_reach_a_launch_counter(dev):
    before = (dict(fa_ops.LAUNCHES), dict(md_ops.LAUNCHES))
    cpu = torch.device("cpu")
    fa_ops.flash_attention(*_fa_inputs(1, 4, 8, 1, 2, 16, torch.float32,
                                       cpu, 0))
    md_ops.mdlora_matmul_multi(*_md_inputs(2, 32, 16, 4, 2, torch.float32,
                                           cpu, 0), scale=2.0)
    md_ops.mdlora_matmul(*_fused_inputs(3, 5, 20, 9, 2, torch.float32, cpu,
                                        0))
    assert (dict(fa_ops.LAUNCHES), dict(md_ops.LAUNCHES)) == before


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    q, k, v, qp, kp = _fa_inputs(1, 4, 8, 1, 2, 16, torch.float32, dev, 0)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, k.bfloat16(), v, qp, kp)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, k, v, qp.long(), kp)
    x, w0, a, b, idx, mask = _md_inputs(2, 32, 16, 4, 2, torch.bfloat16,
                                        dev, 0)
    with pytest.raises(TypeError):
        md_ops.mdlora_matmul_multi(x, w0.float(), a, b, idx, mask)
    with pytest.raises(ValueError, match="shape"):
        md_ops.mdlora_matmul_multi(x, w0, a, b, idx[:1].contiguous(), mask)


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------

# |kernel - plain| <= atol + rtol |plain| + (SUM_RTOL + CUM_ULPS u C) S,
# where S is the same scan over |x|, |B| and |C|, u = 2^-24 and C the
# largest log-decay of a chunk (max |cum|). fp32: both sides sum over n, Q
# and the chunks in another order, so their difference scales with S
# (mamba2's heads: S ~ 400 where y has cancelled to ~0.5), and both take
# exp(cum_i - cum_j) from running sums rounded in their own order, a
# relative error of a few ulps of C per term; a dropped or doubled term
# moves y by more than a thirtieth of S. bf16 x, B, C and y: the plain
# version runs in fp32 on the same values, and the kernel's y is rounded
# once to bf16 (2^-9 relative; the atol covers y near zero).
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 2**-8)}
SSD_SUM_RTOL, SSD_CUM_ULPS = 1e-6, 16


def _ssd_plain(x, dt, A_log, Bm, Cm, chunk):
    """-> ((y, final_state), the same over absolute values) in fp32, and
    the tolerance's factor of S."""
    f = lambda t: t.float()  # noqa: E731
    b, s, h = dt.shape
    C = (torch.exp(A_log) * dt).reshape(b, s // chunk, chunk, h).sum(2)
    return (ssd_ref.ssd_ref(f(x), dt, A_log, f(Bm), f(Cm), chunk),
            ssd_ref.ssd_ref(f(x).abs(), dt, A_log, f(Bm).abs(),
                            f(Cm).abs(), chunk),
            SSD_SUM_RTOL + SSD_CUM_ULPS * 2**-24 * C.max().item())


def _assert_ssd_close(got, want, scale, sum_rtol, atol, rtol):
    err = (got.float() - want).abs()
    bound = atol + rtol * want.abs() + sum_rtol * scale
    assert (err <= bound).all(), (
        f"max abs err {err.max().item():.3e}, worst excess "
        f"{(err - bound).max().item():.3e}")


def _ssd_inputs(b, s, h, p, n, dtype, dev, seed):
    g = np.random.default_rng(seed)
    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    x = t(g.normal(size=(b, s, h, p))).to(dtype)
    dt = torch.nn.functional.softplus(t(g.normal(size=(b, s, h))))
    A_log = t(g.normal(size=h))
    Bm = t(g.normal(size=(b, s, n))).to(dtype)
    Cm = t(g.normal(size=(b, s, n))).to(dtype)
    return x, dt, A_log, Bm, Cm


SSD_CASES = [  # b, s, h, p, n, chunk
    (2, 64, 4, 16, 8, 16), (2, 128, 8, 8, 16, 32), (2, 32, 2, 32, 4, 32),
    (2, 96, 3, 24, 8, 32),     # odd head count
    (1, 30, 5, 6, 5, 10),      # nothing a multiple of 4
    (2, 256, 50, 64, 16, 64),  # hymba FULL heads: h = 50, n = 16
    (2, 256, 64, 64, 128, 64),  # mamba2 FULL heads
    (1, 256, 4, 64, 128, 128),  # chunk 128 (the reference's default)
    (3, 16, 2, 16, 16, 16),    # one chunk
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain(dev, dtype, b, s, h, p, n, chunk):
    x, dt, A_log, Bm, Cm = _ssd_inputs(b, s, h, p, n, dtype, dev,
                                       b + s + h + p + n)
    before = ssd_ops.LAUNCHES["ssd"]
    y, fs = ssd_ops.ssd(x, dt, A_log, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES["ssd"] == before + 1
    assert y.dtype == dtype and fs.dtype == torch.float32
    (yw, fw), (ys, fsum), sum_rtol = _ssd_plain(x, dt, A_log, Bm, Cm, chunk)
    _assert_ssd_close(y, yw, ys, sum_rtol, *SSD_TOL[dtype])
    _assert_ssd_close(fs, fw, fsum, sum_rtol, *SSD_TOL[torch.float32])


def test_ssd_kernel_matches_the_sequential_recurrence(dev):
    x, dt, A_log, Bm, Cm = _ssd_inputs(1, 32, 2, 8, 4, torch.float32, dev, 0)
    y, fs = ssd_ops.ssd(x, dt, A_log, Bm, Cm, 8)
    state = torch.zeros((1, 2, 8, 4), device=dev)
    for t in range(32):
        yt, state = ssm.ssd_decode_step(state, x[:, t], dt[:, t], A_log,
                                        Bm[:, t], Cm[:, t])
        torch.testing.assert_close(y[:, t], yt, atol=1e-4, rtol=0)
    torch.testing.assert_close(fs, state, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ssd_kernel_is_deterministic(dev, dtype):
    args = _ssd_inputs(2, 512, 64, 64, 128, dtype, dev, 1)
    (y1, f1), (y2, f2) = ssd_ops.ssd(*args, 64), ssd_ops.ssd(*args, 64)
    assert torch.equal(y1, y2) and torch.equal(f1, f2)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, dt, A_log, Bm, Cm = _ssd_inputs(1, 64, 2, 8, 4, torch.float32, dev, 0)
    with pytest.raises(ValueError, match="shape"):
        ssd_ops.ssd(x, dt, A_log, Bm, Cm, 16,
                    initial_state=torch.zeros((1, 2, 4, 8), device=dev))
    with pytest.raises(ValueError, match="not divisible"):
        ssd_ops.ssd(x, dt, A_log, Bm, Cm, 24)
    with pytest.raises(ValueError, match="is on"):
        ssd_ops.ssd(x, dt.cpu(), A_log, Bm, Cm, 16)
    with pytest.raises(TypeError):
        ssd_ops.ssd(x, dt, A_log, Bm.bfloat16(), Cm, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                    A_log, Bm, Cm, 16)
    with pytest.raises(ValueError, match="at most"):
        ssd_ops.ssd(*_ssd_inputs(1, 512, 1, 8, 4, torch.float32, dev, 0), 512)
    before = ssd_ops.LAUNCHES["ssd"]
    cpu = [t.cpu() for t in (x, dt, A_log, Bm, Cm)]
    ssd_ops.ssd(*cpu, 16)
    assert ssd_ops.LAUNCHES["ssd"] == before


# the bf16 redesigns: one launch per call, their sum orders, initial state


def _launches(fn):
    """(kernel launches of one call of ``fn`` -- the runtime's launch calls
    the profiler records on the host -- and the names of the device kernels
    it recorded), after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.key.startswith("cudaLaunchKernel"))
    return n, [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("B,D,F", [(16, 5120, 5120), (33, 300, 77)])
def test_mdlora_bf16_call_is_one_launch(dev, B, D, F):
    x, w0, a, b, idx, mask = _md_inputs(B, D, F, 8, 4, torch.bfloat16, dev, 3)
    n, names = _launches(
        lambda: md_ops.mdlora_matmul_multi(x, w0, a, b, idx, mask, 2.0))
    assert n == 1 and all("bf16_kernel" in k for k in names), names
    xf, wf = x.float(), w0.float()
    n, names = _launches(
        lambda: md_ops.mdlora_matmul_multi(xf, wf, a, b, idx, mask, 2.0))
    assert n == 2, names


@pytest.mark.parametrize("B,D,F", [(16, 5120, 1280), (33, 512, 96),
                                   (5, 300, 77), (16, 4800, 1600)])
def test_mdlora_bf16_kernel_matches_its_split_plain(dev, B, D, F):
    """Against the plain version in the kernel's own split order (x*m
    rounded to bf16 once, fp32 partials per split); a fractional mask."""
    x, w0, a, b, idx, mask = _md_inputs(B, D, F, 8, 6, torch.bfloat16, dev,
                                        B + F)
    L, *_ = md_ops.plan_multi(
        D, F, torch.cuda.get_device_properties(dev).multi_processor_count)
    for m in (mask, mask * 0.37 + 0.2):
        got = md_ops.mdlora_matmul_multi(x, w0, a, b, idx, m, 2.0)
        want = md_ref.mdlora_matmul_multi_split_ref(x, w0, a, b, idx, m,
                                                    2.0, L, md_ops.U_LEN)
        atol, rtol = MD_TOL[torch.bfloat16]
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(
            got.float(), md_ref.mdlora_matmul_multi_ref(
                x, w0, a, b, idx, m, 2.0).float(), atol=atol, rtol=rtol)


def test_mdlora_bf16_calls_leave_the_counters_zeroed(dev):
    """Alternating shapes reuse the per-tile arrival counters: each call
    leaves them zeroed, so repeated calls agree bitwise."""
    big = _md_inputs(16, 5120, 5120, 8, 16, torch.bfloat16, dev, 1)
    small = _md_inputs(3, 640, 200, 4, 2, torch.bfloat16, dev, 2)
    first = [md_ops.mdlora_matmul_multi(*big, 2.0),
             md_ops.mdlora_matmul_multi(*small, 2.0)]
    for _ in range(3):
        assert torch.equal(md_ops.mdlora_matmul_multi(*big, 2.0), first[0])
        assert torch.equal(md_ops.mdlora_matmul_multi(*small, 2.0), first[1])
    torch.cuda.synchronize()
    assert int(md_ops._COUNTERS[big[0].device].abs().sum()) == 0


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_bf16_kernel_matches_its_walk_plain(dev, b, s, h, p, n, chunk):
    """The bf16 chunk walk against the plain version in its own order
    (folded dt, bf16 hi + lo operands) on the same bf16 values: only the
    fp32 sums' order and y's bf16 rounding are left."""
    x, dt, A_log, Bm, Cm = _ssd_inputs(b, s, h, p, n, torch.bfloat16, dev,
                                       b + s + h + p + n)
    assert ssd_ops.chunk_walk(chunk, p, n, torch.bfloat16)
    y, fs = ssd_ops.ssd(x, dt, A_log, Bm, Cm, chunk)
    f = lambda t: t.float()  # noqa: E731
    yw, fw = ssd_ref.ssd_walk_ref(f(x), dt, A_log, f(Bm), f(Cm), chunk,
                                  hi_lo=True)
    _, (ys, fsum), sum_rtol = _ssd_plain(x, dt, A_log, Bm, Cm, chunk)
    _assert_ssd_close(y, yw, ys, sum_rtol, *SSD_TOL[torch.bfloat16])
    _assert_ssd_close(fs, fw, fsum, sum_rtol, *SSD_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 16, 8, 16), (1, 30, 5, 6, 5, 10), (2, 256, 64, 64, 128, 64),
    (2, 256, 50, 64, 16, 64)])
def test_ssd_kernel_takes_an_initial_state(dev, dtype, b, s, h, p, n, chunk):
    """A carried state (slow decays keep it in y to the last chunk) against
    the plain version with the same state."""
    x, dt, A_log, Bm, Cm = _ssd_inputs(b, s, h, p, n, dtype, dev, 5 * s + h)
    A_log = A_log - 3.0
    s0 = torch.as_tensor(np.random.default_rng(h).normal(
        size=(b, h, p, n)).astype(np.float32), device=dev)
    y, fs = ssd_ops.ssd(x, dt, A_log, Bm, Cm, chunk, initial_state=s0)
    y0, _ = ssd_ops.ssd(x, dt, A_log, Bm, Cm, chunk)
    f = lambda t: t.float()  # noqa: E731
    yw, fw = ssd_ref.ssd_ref(f(x), dt, A_log, f(Bm), f(Cm), chunk, s0)
    ys, fsum = ssd_ref.ssd_ref(f(x).abs(), dt, A_log, f(Bm).abs(),
                               f(Cm).abs(), chunk, s0.abs())
    C = (torch.exp(A_log) * dt).reshape(b, s // chunk, chunk, h).sum(2)
    sum_rtol = SSD_SUM_RTOL + SSD_CUM_ULPS * 2**-24 * C.max().item()
    _assert_ssd_close(y, yw, ys, sum_rtol, *SSD_TOL[dtype])
    _assert_ssd_close(fs, fw, fsum, sum_rtol, *SSD_TOL[torch.float32])
    assert (y.float() - y0.float()).abs()[:, -chunk:].max() > 1e-2


def test_ssd_bf16_call_is_one_launch(dev):
    args = _ssd_inputs(2, 256, 8, 64, 128, torch.bfloat16, dev, 0)
    n, names = _launches(lambda: ssd_ops.ssd(*args, 64))
    assert n == 1 and all("chunk_kernel" in k for k in names), names
    f32 = [t.float() for t in args]
    n, names = _launches(lambda: ssd_ops.ssd(*f32, 64))
    assert n == 2, names


# the tensor-core fused projection and the one-launch int8 aggregation

FUSED_PATH_CASES = FUSED_CASES + [
    (1024, 32, 112, 128, 8, ("w0",)),  # 1024 clients: the widest column tile
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("K,T,D,F,r,share", FUSED_PATH_CASES)
def test_fused_mdlora_kernel_matches_its_tf32x3_plain(dev, dtype, K, T, D, F,
                                                      r, share):
    """Against the plain version in the kernel's arithmetic (3xTF32 in
    fp32, x*m rounded to bf16 once in bf16) and the one-pass plain version;
    two calls bitwise equal."""
    args = _fused_inputs(K, T, D, F, r, dtype, dev, 3 * K + D, share)
    got = md_ops.mdlora_matmul(*args)
    atol, rtol = MD_TOL[dtype]
    for want in (md_ref.mdlora_matmul_tf32x3_ref(*args),
                 md_ref.mdlora_matmul_ref(*args)):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    assert torch.equal(md_ops.mdlora_matmul(*args), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_mdlora_slice_rows_do_not_depend_on_K(dev, dtype):
    """The path's 8 slices, alone, and inside 1024 (another column tile):
    the same bits."""
    big = _fused_inputs(1024, 32, 112, 128, 8, dtype, dev, 11)
    x, w0, a, b, mask, s = big
    full = md_ops.mdlora_matmul(*big)
    eight = md_ops.mdlora_matmul(x[:8].contiguous(), w0, a[:8].contiguous(),
                                 b[:8].contiguous(), mask[:8].contiguous(), s)
    one = md_ops.mdlora_matmul(x[3], w0, a[3], b[3], mask[3], s)
    assert torch.equal(full[:8], eight)
    assert torch.equal(full[3], one)


@pytest.mark.parametrize("K,T,D,F,r,share", FUSED_PATH_CASES)
def test_fused_mdlora_call_is_one_launch(dev, K, T, D, F, r, share):
    args = _fused_inputs(K, T, D, F, r, torch.float32, dev, 1, share)
    n, names = _launches(lambda: md_ops.mdlora_matmul(*args))
    assert n == 1 and all("fused_kernel" in k for k in names), names


QUANT_SHAPES = SHAPES + [(4096, 112, 4), (2000, 7, 1000),
                         (64, 3, 2048)]  # rows wider than a block: passes


@pytest.mark.parametrize("N,D,r", QUANT_SHAPES)
@pytest.mark.parametrize("exponent", [0.0, 0.5])
def test_quant_kernel_matches_its_split_plain(dev, N, D, r, exponent):
    _, W, C, q, s, st = _inputs(N, D, r, 5 * N + r, dev)
    plan = ops.plan_agg(
        N, D, r, torch.cuda.get_device_properties(dev).multi_processor_count)
    got = ops.cohort_agg_divergence_quant(q, s, W, C, st, exponent)
    for want in (ref.cohort_agg_divergence_quant_split_ref(
                     q, s, W, C, st, exponent, plan.splits, plan.lanes),
                 ref.cohort_agg_divergence_quant_ref(q, s, W, C, st,
                                                     exponent)):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("N,D,r", [(4, 112, 128), (16384, 1024, 4),
                                   (300, 100, 1), (2000, 7, 1000)])
def test_quant_call_is_one_launch(dev, N, D, r):
    _, W, C, q, s, st = _inputs(N, D, r, 0, dev)
    n, names = _launches(
        lambda: ops.cohort_agg_divergence_quant(q, s, W, C, st, 0.5))
    assert n == 1 and all("agg_kernel" in k for k in names), names
    x = q.float()
    n, names = _launches(lambda: ops.cohort_agg_divergence(x, W, C))
    assert n == 1 and all("agg_kernel" in k for k in names), names


@pytest.mark.parametrize("N,D,r", QUANT_SHAPES)
@pytest.mark.parametrize("empty", [False, True], ids=["cohort", "empty"])
def test_fp32_kernel_matches_its_split_plain(dev, N, D, r, empty):
    x, W, C, *_ = _inputs(N, D, r, 3 * N + D + r, dev, empty)
    plan = ops.plan_agg(
        N, D, r, torch.cuda.get_device_properties(dev).multi_processor_count)
    got = ops.cohort_agg_divergence(x, W, C)
    for want in (ref.cohort_agg_divergence_split_ref(x, W, C, plan.splits,
                                                     plan.lanes),
                 ref.cohort_agg_divergence_ref(x, W, C)):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("N,D,r", [(4, 112, 128), (16384, 1024, 4),
                                   (300, 100, 1), (2000, 7, 1000)])
def test_fp32_call_is_one_launch(dev, N, D, r):
    x, W, C, *_ = _inputs(N, D, r, 0, dev)
    n, names = _launches(lambda: ops.cohort_agg_divergence(x, W, C))
    assert n == 1 and all("agg_kernel" in k for k in names), names


def test_fp32_kernel_is_deterministic_and_leaves_counters_zeroed(dev):
    """As the int8 test below: a multi-split shape alternating with a
    smaller one that reuses the tile counters."""
    big = _inputs(4096, 112, 4, 2, dev)
    small = _inputs(300, 100, 1, 3, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert ops.plan_agg(300, 100, 1, sms).splits > 1
    call = lambda t: ops.cohort_agg_divergence(*t[:3])  # noqa: E731
    first = [call(big), call(small)]
    for _ in range(3):
        for t, want in zip((big, small), first):
            for u, v in zip(call(t), want):
                assert torch.equal(u, v)
    torch.cuda.synchronize()
    assert int(ops._COUNTERS[big[0].device].abs().sum()) == 0


@pytest.mark.parametrize("r", [4, 128])
def test_fp32_wrapper_rejects_a_view_off_by_4_bytes(dev, r):
    """float4 spans need 16-byte alignment: a contiguous view that starts
    one float into its storage raises (no fallback to one-float spans,
    which would change the order of the sums); r % 4 != 0 takes one-float
    spans and runs."""
    N, D = 4, 112
    x, W, C, *_ = _inputs(N, D, r, 4, dev)
    flat = torch.empty(N * D * r + 1, device=dev)
    view = flat[1:].view(N, D, r)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.cohort_agg_divergence(view, W, C)
    odd = torch.empty(N * D * 3 + 1, device=dev)[1:].view(N, D, 3)
    odd.copy_(x[..., :3])
    got = ops.cohort_agg_divergence(odd, W, C)
    for a, b in zip(got, ref.cohort_agg_divergence_ref(odd, W, C)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


def test_quant_kernel_is_deterministic_and_leaves_counters_zeroed(dev):
    """A multi-split shape, alternating with a smaller one that reuses the
    tile counters: each call leaves them zeroed, repeated calls agree
    bitwise."""
    big = _inputs(4096, 112, 4, 0, dev)
    small = _inputs(300, 100, 1, 1, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert ops.plan_agg(4096, 112, 4, sms).splits > 1
    assert ops.plan_agg(300, 100, 1, sms).splits > 1
    call = lambda t: ops.cohort_agg_divergence_quant(  # noqa: E731
        t[3], t[4], t[1], t[2], t[5], 0.5)
    first = [call(big), call(small)]
    for _ in range(3):
        for t, want in zip((big, small), first):
            for u, v in zip(call(t), want):
                assert torch.equal(u, v)
    torch.cuda.synchronize()
    assert int(ops._COUNTERS[big[3].device].abs().sum()) == 0


# -- the async runtimes on Backbone 2 ---------------------------------------

B2_FUSION = [(1, 112, 8), (4, 112, 8), (64, 112, 8)]  # PAMAP2_B2's a [112, 8]


@pytest.mark.parametrize("N,D,r", B2_FUSION)
def test_kernels_at_the_b2_fusion_shape(dev, N, D, r):
    """Both uplinks at B2's fusion shape (float4 / char4 spans at r = 8):
    the one-pass and split-order plain versions, one launch per call."""
    x, W, C, q, s, st = _inputs(N, D, r, 11 * N, dev)
    plan = ops.plan_agg(
        N, D, r, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert plan.vec == 4
    got = ops.cohort_agg_divergence(x, W, C)
    for want in (ref.cohort_agg_divergence_ref(x, W, C),
                 ref.cohort_agg_divergence_split_ref(x, W, C, plan.splits,
                                                     plan.lanes)):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    got = ops.cohort_agg_divergence_quant(q, s, W, C, st, 0.5)
    for want in (ref.cohort_agg_divergence_quant_ref(q, s, W, C, st, 0.5),
                 ref.cohort_agg_divergence_quant_split_ref(
                     q, s, W, C, st, 0.5, plan.splits, plan.lanes)):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    assert _launches(lambda: ops.cohort_agg_divergence(x, W, C))[0] == 1
    assert _launches(lambda: ops.cohort_agg_divergence_quant(
        q, s, W, C, st, 0.5))[0] == 1


def _b2_task(dev, full=True):
    from repro_torch.configs.relief_har import PAMAP2_B2, PAMAP2_B2_SMALL
    from repro_torch.core.tasks import MMTask

    return MMTask.create(PAMAP2_B2 if full else PAMAP2_B2_SMALL,
                         torch.Generator().manual_seed(0), device=dev)


@pytest.mark.parametrize("kind", ["trimmed", "median", "krum"])
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_robust_buffer_flush_on_card_matches_cpu(dev, kind, codec):
    """A robust flush of 5 B2 FULL clients (one x1000 attacker) on the card
    against the same flush on the CPU: the statistics through the fp32
    kernel (int8 dequantizes first), one launch, the robust aggregate."""
    from repro_torch import dist
    from repro_torch.core import aggregation as AG
    from repro_torch.tree import leaves_with_path, tree_map

    task, tr0 = _b2_task("cpu")
    layout = task.layout
    g = torch.Generator().manual_seed(5)
    d = tree_map(lambda x: 0.01 * torch.randn((5,) + x.shape, generator=g),
                 tr0)
    d = tree_map(lambda x: torch.cat([x[:1] * 1000.0, x[1:]]), d)
    trained = (torch.rand((5, layout.G), generator=g) > 0.25).float()
    mm = torch.ones((5, layout.n_modalities))
    mm[1, 3] = 0.0
    C = torch.as_tensor(layout.accessible(mm.numpy()), dtype=torch.float32
                        ) * trained
    stale = torch.tensor([0.0, 1.0, 2.0, 0.0, 3.0])
    q, sc, _ = dist.quantize_int8_stacked(d)  # one set of codes for both
    out = {}
    for where in ("cuda", "cpu"):
        mv = lambda t: tree_map(lambda x: x.to(where), t)  # noqa: E731
        buf = AG.CohortAggBuffer(layout, mv(tr0), robust=kind, trim_frac=0.25)
        W = AG.cohort_weights(layout, trained.to(where), mm.to(where),
                              client_scale=AG.staleness_discounts(
                                  stale.to(where), 0.5),
                              defer_scale=codec == "int8")
        before = dict(ops.LAUNCHES)
        if codec == "int8":
            buf.push_quantized(mv(q), mv(sc), W, C.to(where),
                               stale.to(where), 0.5)
        else:
            buf.push(mv(d), W, C.to(where))
        agg, div, cnt = buf.finalize()
        if where == "cuda":
            torch.cuda.synchronize()
            assert ops.LAUNCHES["cohort_agg_divergence"] == \
                before["cohort_agg_divergence"] + 1
            assert ops.LAUNCHES["cohort_agg_divergence_quant"] == \
                before["cohort_agg_divergence_quant"]
        out[where] = ({p: v.cpu() for p, v in leaves_with_path(agg)},
                      div.cpu(), cnt.cpu())
    (ac, dc, cc), (ap, dp, cp) = out["cuda"], out["cpu"]
    for p in ap:
        torch.testing.assert_close(ac[p], ap[p], atol=ATOL, rtol=RTOL, msg=p)
    torch.testing.assert_close(dc, dp, atol=ATOL, rtol=RTOL)
    assert torch.equal(cc, cp)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_vectorized_cohort_flush_on_card_matches_cpu(dev, codec):
    """One grad_mode="cohort" flush of 8 clients from a scaled fleet of 64
    (counter-based batch draws, ring snapshots) on PAMAP2_B2_SMALL: the
    card's trainable and loss against the CPU's, and one aggregation
    launch of the codec's kernel on the card. The trainable to atol 1e-4;
    with int8, plus one int8 step of each leaf (its largest dequant scale):
    the card's deltas differ from the CPU's in their last bits, so a code
    whose x/scale lies that close to k + 1/2 rounds the other way."""
    from repro_torch.core import strategies
    from repro_torch.core.async_engine import (AsyncFedConfig,
                                               VectorizedAsyncFedRun)
    from repro_torch.data import make_har_dataset
    from repro_torch.sim import make_fleet, scale_fleet
    from repro_torch.tree import leaves_with_path

    ds = make_har_dataset("pamap2", windows_per_subject=60, seed=0)
    out = {}
    for where in ("cuda", "cpu"):
        task, tr0 = _b2_task(where, full=False)
        run = VectorizedAsyncFedRun.create(
            task, tr0, strategies.async_relief(buffer_size=8),
            scale_fleet(make_fleet(3, 3, 2, M=4), 64,
                        np.random.default_rng(1)),
            AsyncFedConfig(rounds=1, local_epochs=1, steps_per_epoch=2,
                           batch_size=8, eval_every=0, seed=0,
                           grad_mode="cohort", snapshot_ring=4,
                           uplink_codec=codec))
        steps, flush = {}, run._flush_arrays

        def record(deltas, *args, **kw):
            if codec == "int8":
                steps.update({p: v.max().item() for p, v in
                              leaves_with_path(deltas.scales)})
            return flush(deltas, *args, **kw)

        run._flush_arrays = record
        ops.reset_launches()
        hist = run.run(ds, total_updates=8)
        if where == "cuda":
            torch.cuda.synchronize()
            name = ("cohort_agg_divergence_quant" if codec == "int8"
                    else "cohort_agg_divergence")
            assert ops.LAUNCHES[name] == run.state.round == 1
        out[where] = (hist["loss"], {p: v.cpu() for p, v in
                                     leaves_with_path(run.state.trainable)},
                      steps)
    (lc, tc, sc), (lp, tp, _) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(lc, lp, rtol=1e-4)
    for p in tp:
        torch.testing.assert_close(tc[p], tp[p], atol=1e-4 + sc.get(p, 0.0),
                                   rtol=0, msg=p)


def _seeded_tree(tr0, K, seed, where):
    from repro_torch.tree import tree_map

    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda x: (0.01 * torch.randn((K,) + tuple(x.shape),
                                                  generator=g)).to(where),
                    tr0)


@pytest.mark.parametrize("K", [4, 64])
def test_group_norms_are_bitwise_repeatable_on_card(dev, K):
    """``mdlora.group_norms`` on B2 FULL client-stacked deltas: two calls on
    the card give the same bits (no atomics), and the card's norms agree
    with the CPU's (fp32 sums over a row in another order)."""
    from repro_torch.core import mdlora

    task, tr0 = _b2_task("cpu")
    d = _seeded_tree(tr0, K, K, "cpu")
    dc = _seeded_tree(tr0, K, K, dev)
    a = mdlora.group_norms(task.layout, dc, batch_dims=1)
    b = mdlora.group_norms(task.layout, dc, batch_dims=1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), mdlora.group_norms(
        task.layout, d, batch_dims=1), atol=0, rtol=1e-5)


@pytest.mark.parametrize("full", [False, True], ids=["small", "full"])
def test_selective_upload_on_card_equals_cpu(dev, full):
    """FedMFS's upload rows S_up from the same B2 deltas on the card and on
    the CPU, two budgets; the gated rows equal the CPU's exactly."""
    from repro_torch.core.async_engine import _gate_rows, _selective_upload
    from repro_torch.tree import leaves_with_path

    task, tr0 = _b2_task("cpu", full=full)
    K, G = 8, task.layout.G
    d = _seeded_tree(tr0, K, 5, "cpu")
    dc = _seeded_tree(tr0, K, 5, dev)
    S = np.random.default_rng(2).random((K, G)) > 0.25
    S &= task.layout.sizes[None, :] > 0
    for budget in (0.3, 0.5):
        up = _selective_upload(task.layout, d, S, budget)
        assert np.array_equal(_selective_upload(task.layout, dc, S, budget),
                              up)
        gc = dict(leaves_with_path(_gate_rows(task.layout, dc, up)))
        for p, v in leaves_with_path(_gate_rows(task.layout, d, up)):
            assert torch.equal(gc[p].cpu(), v), p


def test_stream_heap_and_vectorized_equal_on_card(dev):
    """stream30 on PAMAP2_B2_SMALL (fedmfs_selective, 3 flushes) through
    ``make_run`` on the card: the heap and the vectorized runtime's flush
    histories equal, losses to rtol 1e-5; one aggregation launch per
    flush each."""
    from repro_torch.sim import get_scenario, make_run

    spec = get_scenario("stream30", strategy="fedmfs_selective",
                        backbone="transformer", small_model=True,
                        windows_per_subject=40, local_epochs=1,
                        steps_per_epoch=2, batch_size=8, eval_every=0,
                        total_updates=12)
    hists = []
    for vec in (False, True):
        run, sc = make_run(spec, vec, device=dev)
        ops.reset_launches()
        hists.append(run.run(sc.dataset))
        torch.cuda.synchronize()
        assert ops.LAUNCHES["cohort_agg_divergence"] == run.state.round == 3
    h, v = hists
    for key in ("flush", "staleness_mean", "selected_frac", "sim_time_s",
                "energy_j"):
        assert v[key] == h[key], key
    np.testing.assert_allclose(v["upload_mb"], h["upload_mb"], rtol=1e-9)
    np.testing.assert_allclose(v["loss"], h["loss"], rtol=1e-5)


def test_run_spec_on_card_matches_cpu(dev):
    """One experiment-runner run (relief, PAMAP2 B2 small width, 2 rounds)
    on the card against the CPU from the same seed: simulated time, energy
    and upload equal, losses to rtol 1e-4, macro-F1 to atol 0.02."""
    from repro_torch.launch import experiments as X

    spec = X.BenchSpec("relief", "pamap2", "b2", 2, windows=40)
    got = {where: X.run_spec(spec, verbose=False, device=where,
                             cache_dir=None) for where in (dev, "cpu")}
    c, p = got[dev], got["cpu"]
    assert c["device"] != "cpu" and p["device"] == "cpu"
    for key in ("round_times", "energy_j", "upload_mb", "selected_frac",
                "f1_rounds"):
        assert c[key] == p[key], key
    np.testing.assert_allclose(c["loss_curve"], p["loss_curve"], rtol=1e-4)
    np.testing.assert_allclose(c["f1_curve"], p["f1_curve"], atol=0.02)
    for m, v in p["per_modality_f1"].items():
        np.testing.assert_allclose(c["per_modality_f1"][m], v, atol=0.02)


def _ckpt_tree(where):
    g = torch.Generator().manual_seed(7)
    return {"enc": {"w": torch.randn((3, 4), generator=g).to(where),
                    "b": torch.randn((5,), generator=g).bfloat16().to(where)},
            "steps": torch.tensor([7, -2], dtype=torch.int32).to(where)}


def test_checkpoint_moves_between_card_and_cpu_bitwise(dev, tmp_path):
    """A checkpoint saved from card tensors restores onto the CPU bit for
    bit, and one saved from CPU tensors onto the card; a bf16 leaf keeps
    its bits both ways."""
    from repro_torch.checkpoint import restore_tree, save_tree
    from repro_torch.tree import leaves_with_path, tree_map

    for src, dst in ((dev, torch.device("cpu")), (torch.device("cpu"), dev)):
        tree = _ckpt_tree(src)
        path = str(tmp_path / f"from_{src.type}")
        save_tree(path, tree, {"from": src.type})
        like = tree_map(lambda t: torch.zeros_like(t, device=dst), tree)
        got, meta = restore_tree(path, like)
        assert meta == {"from": src.type}
        want = dict(leaves_with_path(tree))
        for p, t in leaves_with_path(got):
            assert t.device.type == dst.type and t.dtype == want[p].dtype, p
            a, b = t.cpu(), want[p].cpu()
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), p


def test_motivation_on_card_matches_cpu(dev):
    """Figs. 2-3 (PAMAP2_B1_SMALL, 2 instrumented FedAvg rounds) on the card
    against the CPU from the same seed, at the CPU test's tolerances: the
    cosines to atol 1e-4, divergences and Mag/Acc ratios to rtol 1e-3
    (cuDNN's convolutions with TF32 off)."""
    from repro_torch.launch import experiments as X

    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = {where: X.motivation(2, device=where, cache_dir=None)
               for where in (dev, "cpu")}
    finally:
        torch.backends.cudnn.allow_tf32 = was
    c, p = got[dev], got["cpu"]
    assert c["device"] != "cpu" and p["device"] == "cpu"
    for pt, blocks in p["fig2_block_cosine"].items():
        assert list(c["fig2_block_cosine"][pt]) == list(blocks)
        np.testing.assert_allclose(list(c["fig2_block_cosine"][pt].values()),
                                   list(blocks.values()), atol=1e-4)
    for blk, vals in p["fig3_divergence_phases"].items():
        np.testing.assert_allclose(c["fig3_divergence_phases"][blk], vals,
                                   rtol=1e-3)
    np.testing.assert_allclose(c["obs2_rare_to_common_ratio"],
                               p["obs2_rare_to_common_ratio"], rtol=1e-3)


# ---------------------------------------------------------------------------
# the rest of the model zoo: kernels 5 and 4 at its shapes, one MoE layer
# ---------------------------------------------------------------------------


def _wrapped_ring(T, last):
    """kv positions of a ring of T slots that has wrapped: positions
    last-T+1..last, each at slot pos % T."""
    pos = np.arange(last - T + 1, last + 1)
    kv = np.empty(T, np.int32)
    kv[pos % T] = pos
    return kv


ZOO_FA_CASES = [  # label, B, S, T, K, G, hd, window, wrapped?
    ("mixtral decode, wrapped ring", 2, 1, 4096, 8, 4, 128, 4096, True),
    ("mixtral prefill, wrapped ring", 1, 64, 4096, 8, 4, 128, 4096, True),
    ("granite-34b MQA decode", 2, 1, 300, 1, 48, 128, None, False),
    ("musicgen MHA decode", 2, 1, 300, 32, 1, 64, None, False),
    ("musicgen MHA prefill", 2, 64, 300, 32, 1, 64, None, False),
    ("llava G=7 prefill", 1, 200, 256, 8, 7, 128, None, False),
]


@pytest.mark.parametrize("label,B,S,T,K,G,hd,window,wrapped", ZOO_FA_CASES,
                         ids=[c[0] for c in ZOO_FA_CASES])
def test_flash_bf16_kernel_at_the_zoo_layouts(dev, label, B, S, T, K, G, hd,
                                              window, wrapped):
    """bf16 at mixtral's 4096 window over a wrapped ring, granite-34b's MQA
    (S*G = 48 > DECODE_ROWS: a decode call takes the prefill path),
    musicgen's MHA (hd 64) and llava's G = 7; each call takes the path its
    S*G selects."""
    q, k, v, qp, kp = _fa_inputs(B, S, T, K, G, hd, torch.bfloat16, dev,
                                 B + S + T + G)
    if wrapped:
        kv = _wrapped_ring(T, 5000)
        kp = torch.as_tensor(kv, device=dev)
        qp = torch.arange(5001 - S, 5001, dtype=torch.int32, device=dev)
    path = "decode" if S * G <= fa_ops.DECODE_ROWS else "prefill"
    assert (label.startswith("granite") and path == "prefill") or \
        not label.startswith("granite")
    before = dict(fa_ops.PATH_LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, qp, kp, window, None)
    torch.cuda.synchronize()
    assert fa_ops.PATH_LAUNCHES[path] == before[path] + 1
    want = fa_ref.flash_attention_ref(q, k, v, qp, kp, window, None)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FA_ATOL[torch.bfloat16], rtol=0)


ZOO_MD_CASES = [  # label, D, F, blocks (None: no mask)
    ("mixtral wq", 4096, 4096, None),
    ("mixtral wv", 4096, 1024, None),
    ("mixtral wo", 4096, 4096, [512] * 8),
    ("granite-34b wv", 6144, 128, None),
]


@pytest.mark.parametrize("label,D,F,blocks", ZOO_MD_CASES,
                         ids=[c[0] for c in ZOO_MD_CASES])
def test_mdlora_bf16_kernel_at_the_zoo_shapes(dev, label, D, F, blocks):
    x, w0, a, b, idx, mask = _md_inputs(16, D, F, 8, 16, torch.bfloat16,
                                        dev, D + F, dims=blocks or [D])
    mask = mask if blocks else None
    before = md_ops.LAUNCHES["mdlora_matmul_multi"]
    got = md_ops.mdlora_matmul_multi(x, w0, a, b, idx, mask, 2.0)
    torch.cuda.synchronize()
    assert md_ops.LAUNCHES["mdlora_matmul_multi"] == before + 1
    want = md_ref.mdlora_matmul_multi_ref(x, w0, a, b, idx, mask, 2.0)
    atol, rtol = MD_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_moe_layer_on_card_matches_cpu(dev):
    """One fp32 MoE layer (8 experts, top-2) at a prefill shape where
    capacity drops occur, on the card against the CPU from the same
    weights, TF32 off: the same expert ids, the same kept (token, expert)
    assignments, the output to atol 1e-4."""
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(0)
    p = moe.init_moe_mlp(g, 256, 512, 8, "cpu")
    # a shared component skews the routing: 59 of 1024 assignments drop
    x = torch.randn((4, 128, 256), generator=g) \
        + 0.2 * torch.randn(256, generator=g)
    cap = moe.capacity(128, 2, 8, 1.25)
    got = {}
    for where in ("cpu", dev):
        pw = {k: v.to(where) for k, v in p.items()}
        xw = x.to(where)
        _, _, ids = moe.route(pw, xw, 2)
        _, rank, slot = moe.dispatch(ids, 8, cap)
        out, aux = moe.moe_mlp(pw, xw, top_k=2)
        got[str(where)] = (ids.cpu(), slot.cpu(), (rank >= cap).sum().item(),
                           out.cpu(), float(aux))
    c, d = got["cpu"], got[str(dev)]
    assert c[2] > 0  # some assignments are dropped
    assert torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])
    torch.testing.assert_close(d[3], c[3], atol=1e-4, rtol=0)
    assert abs(c[4] - d[4]) <= 1e-5


def _dropless_inputs(B, S, dev, dtype, empty):
    """An 8-expert layer (d 256, f 512) and x [B, S, 256]; with ``empty``
    x's last feature is 5 and the router's weight of it for expert 7 is
    -100, so no token picks expert 7 and its segment has no row."""
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(B * S)
    p = moe.init_moe_mlp(g, 256, 512, 8, "cpu")
    x = torch.randn((B, S, 256), generator=g)
    if empty:
        x[..., -1] = 5.0
        p["router"][-1, 7] = -100.0
    card = {k: v.to(dev) if k == "router" else v.to(dev, dtype)
            for k, v in p.items()}
    return p, x, card, x.to(dev, dtype)


@pytest.mark.parametrize("B,S", [(64, 1), (1, 512)], ids=["decode",
                                                          "prefill"])
@pytest.mark.parametrize("empty", [False, True], ids=["all", "empty"])
def test_dropless_moe_is_one_grouped_product_per_matrix(dev, B, S, empty):
    """bf16 on the card: one ``moe.experts`` span, whose grouped products
    are three CUTLASS grouped GEMMs, each with its one set-up kernel,
    whatever the number of experts (an expert with no row included); its
    ``assignments`` and ``load`` count every assignment; the output within
    bf16's rounding of the CPU layer's in fp32 on the same bf16 values."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace
    from repro_torch.models import moe

    _, _, pc, xc = _dropless_inputs(B, S, dev, torch.bfloat16, empty)
    # the same bf16 values in fp32 on the CPU: the same routes
    want, _ = moe.moe_mlp({k: v.float().cpu() for k, v in pc.items()},
                          xc.float().cpu(), top_k=2, impl="dropless")
    moe.moe_mlp(pc, xc, top_k=2, impl="dropless")  # warm
    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got, _ = moe.moe_mlp(pc, xc, top_k=2, impl="dropless")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    gemm = [n for n in names if "GroupProblemShape" in n]
    setup = [n for n in names if "prepare_grouped_gemm" in n]
    assert len(gemm) == 3 and len(setup) == 3, names
    rec = [r for r in trace.records() if r.name == "moe.experts"]
    trace.clear()
    assert len(rec) == 1 and rec[0].attrs["assignments"] == 2 * B * S
    load = rec[0].attrs["load"].cpu()
    assert load.shape == (8,) and int(load.sum()) == 2 * B * S
    assert (int(load[7]) == 0) == empty
    torch.testing.assert_close(got.float().cpu(), want, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("empty", [False, True], ids=["all", "empty"])
def test_dropless_moe_on_card_matches_cpu_at_fp32(dev, empty):
    """fp32, TF32 off: the dropless layer on the card against the CPU's at
    a prefill shape (4 rows of 128), the same expert ids, the output to
    atol 1e-4."""
    from repro_torch.models import moe

    p, x, pc, xc = _dropless_inputs(4, 128, dev, torch.float32, empty)
    want, _ = moe.moe_mlp(p, x, top_k=2, impl="dropless")
    got, _ = moe.moe_mlp(pc, xc, top_k=2, impl="dropless")
    assert torch.equal(moe.route(pc, xc, 2)[2].cpu(), moe.route(p, x, 2)[2])
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the no-backward guard and the LM train step
# ---------------------------------------------------------------------------


def test_kernels_refuse_autograd_on_card(dev):
    """Each kernel writes its output through a raw pointer, so under
    autograd its output would have no grad_fn: flash attention, the
    gathered projection, the SSD scan and the raw fused projection raise
    when grad mode is on and an input requires a gradient, and run under
    no_grad. The fused projection trains through its autograd Function."""
    q, k, v, qp, kp = _fa_inputs(2, 8, 45, 2, 2, 64, torch.float32, dev, 3)
    x, w0, a, b, idx, mask = _md_inputs(8, 64, 128, 4, 3, torch.float32,
                                        dev, 0)
    sx, dt, A_log, Bm, Cm = _ssd_inputs(2, 64, 4, 16, 8, torch.float32, dev,
                                        0)
    fx, fw0, fa, fb, fm, scale = _fused_inputs(8, 32, 112, 128, 8,
                                               torch.float32, dev, 0)
    calls = [
        (lambda: fa_ops.flash_attention(q, k, v, qp, kp), q),
        (lambda: md_ops.mdlora_matmul_multi(x, w0, a, b, idx, mask), a),
        (lambda: ssd_ops.ssd(sx, dt, A_log, Bm, Cm, 16), sx),
        (lambda: md_ops.mdlora_matmul(fx, fw0, fa, fb, fm, scale), fa),
    ]
    for call, leaf in calls:
        leaf.requires_grad_()
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
        with torch.no_grad():
            call()
        leaf.requires_grad_(False)
    fa.requires_grad_()
    fused_block_lora(fx, fw0, fa, fb, fm, scale).square().sum().backward()
    want = fa.detach().clone().requires_grad_()
    md_ref.mdlora_matmul_ref(fx, fw0, want, fb, fm, scale).square().sum() \
        .backward()
    torch.testing.assert_close(fa.grad, want.grad, atol=1e-3, rtol=1e-3)


TRAIN_FAMILIES = ["phi3-medium-14b", "gemma2-27b", "mixtral-8x7b",
                  "llava-next-34b", "musicgen-large", "mamba2-1.3b",
                  "hymba-1.5b"]


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_train_step_on_card_matches_cpu(dev, arch, remat):
    """Two ``make_train_step`` steps (full mode) of the fp32 SMOKE config
    on the card against the CPU from the same weights and batches, TF32
    off: losses and gradient norms at rtol 1e-5, Adam's m at 1e-4 of each
    leaf's largest, parameters within Adam's 2 * lr per step (an element
    whose gradient is near its rounding may take the other sign at step
    1)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic_token_batches
    from repro_torch.launch import step_fns
    from repro_torch.models import api
    from repro_torch.optim import adam_init
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(get_arch(arch).SMOKE, remat=remat)
    cpu = api.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    out = {}
    for where in ("cpu", dev):
        params = tree_map(lambda t, w=where: t.to(w), cpu)
        opt = adam_init(params)
        step = step_fns.make_train_step(cfg, lr=1e-3, train_mode="full")
        hist = []
        for b in synthetic_token_batches(cfg.vocab, 2, 32, 2,
                                         n_codebooks=cfg.n_codebooks):
            batch = {k: torch.as_tensor(v, device=where)
                     for k, v in b.items()}
            if cfg.family == "vlm":
                batch["patches"] = torch.zeros(
                    (2, cfg.n_patches, cfg.d_model), device=where)
            params, opt, m = step(params, opt, batch)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        out[str(where)] = (hist, [t.cpu() for t in leaves(params)],
                           [t.cpu() for t in leaves(opt["m"])])
    (hc, pc, mc), (hg, pg, mg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(np.asarray(hg), np.asarray(hc), rtol=1e-5)
    for a, b in zip(mg, mc):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * b.abs().max().item())
    for a, b in zip(pg, pc):
        torch.testing.assert_close(a, b, rtol=0, atol=2 * 1e-3 * 2)


# ---------------------------------------------------------------------------
# launch plans: the autotuner's candidates (kernels/cohort_agg/autotune.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,D,r", [(4, 112, 128), (64, 112, 8), (300, 100, 1)])
def test_agg_kernels_under_every_candidate_plan(dev, N, D, r):
    """Every AggPlan the sweep may pick gives the plain version's values
    within the kernel's tolerance, both uplinks."""
    from repro_torch.kernels.cohort_agg import autotune

    x, W, C, q, s, st = _inputs(N, D, r, N + D + r, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = ref.cohort_agg_divergence_ref(x, W, C)
    want_q = ref.cohort_agg_divergence_quant_ref(q, s, W, C, st, 0.5)
    for plan in autotune.agg_candidates(N, D, r, sms):
        for got, exp in ((ops.cohort_agg_divergence(x, W, C, plan=plan),
                          want),
                         (ops.cohort_agg_divergence_quant(
                             q, s, W, C, st, 0.5, plan=plan), want_q)):
            for a, b in zip(got, exp):
                torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_fused_kernel_bits_ignore_the_block_count(dev):
    """Kernel 3 under any count of persistent blocks gives the same bits
    (each tile is summed by one block in one order)."""
    from repro_torch.kernels.cohort_agg import autotune

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((8, 32, 112), device=dev, generator=g)
    w0 = torch.randn((112, 128), device=dev, generator=g) / 11
    a = torch.randn((8, 112, 8), device=dev, generator=g) / 11
    b = torch.randn((8, 8, 128), device=dev, generator=g) / 20
    mask = (torch.rand((8, 112), device=dev, generator=g) < 0.8).float()
    base = md_ops.mdlora_matmul(x, w0, a, b, mask, 2.0)
    default = md_ops.fused_blocks()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in autotune.fused_candidates(32, default, sms) + [1, 3]:
        assert torch.equal(md_ops.mdlora_matmul(x, w0, a, b, mask, 2.0,
                                                plan=n), base), n
        assert md_ops.fused_blocks() == min(n, 32)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
def test_multi_kernel_under_every_candidate_plan(dev, bf16):
    from repro_torch.kernels.cohort_agg import autotune

    B, D, F, A, r = 16, 1600, 320, 4, 8
    dt = torch.bfloat16 if bf16 else torch.float32
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((B, D), device=dev, generator=g).to(dt)
    w0 = (torch.randn((D, F), device=dev, generator=g) / 40).to(dt)
    a = torch.randn((A, D, r), device=dev, generator=g) / 40
    b = torch.randn((A, r, F), device=dev, generator=g) * 0.05
    idx = torch.randint(0, A, (B,), device=dev, generator=g,
                        dtype=torch.int32)
    want = md_ref.mdlora_matmul_multi_ref(x, w0, a, b, idx, None, 2.0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tol = dict(rtol=1e-2, atol=2e-2) if bf16 else dict(rtol=1e-4, atol=1e-4)
    for plan in autotune.multi_candidates(D, F, r, sms, dt):
        got = md_ops.mdlora_matmul_multi(x, w0, a, b, idx, None, 2.0,
                                         plan=plan)
        torch.testing.assert_close(got.float(), want.float(), **tol)


_CLOCK_PROBE = """
import json, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch import trace
dev = torch.device("cuda")
torch.cuda._sleep(1000)  # the sleep kernel's first launch, untraced
torch.cuda.synchronize(dev)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    with trace.span("issue") as issue:
        torch.cuda._sleep(20_000_000)  # cycles: about 10 ms
    with trace.wait("sync") as sync:
        torch.cuda.synchronize(dev)
print(json.dumps({"issue": [issue.start, issue.end],
                  "sync": [sync.start, sync.end],
                  "device": [[e.name(), e.start_ns(), e.end_ns()]
                             for e in prof.profiler.kineto_results.events()
                             if e.device_type() == DeviceType.CUDA]}))
"""


def test_trace_spans_share_the_device_trace_clock(dev):
    """A span issues a sleep kernel and a wait synchronises, under the
    profiler with CUDA activity only, in a fresh process, as the benchmark
    traces (in a process that has run profiler sessions with CPU activity,
    a CUDA-only session has recorded no device event): the kernel's device
    interval lies between the span's start and the wait's end, to 50 us, so
    the program's spans and the device trace share one clock."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", _CLOCK_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    (i0, i1), (w0, w1) = got["issue"], got["sync"]
    for name, s0, s1 in got["device"]:
        print(f"[clock] device event {name}: {s0 - i0} ns to {s1 - i0} ns "
              "from the span's start")
    ev = [e for e in got["device"] if "spin_kernel" in e[0]]
    assert len(ev) == 1, got["device"]
    _, k0, k1 = ev[0]
    print(f"[clock] {ev[0][0]}: starts {(k0 - i0) / 1e3:.1f} us after the "
          f"span's start ({(i1 - i0) / 1e3:.1f} us long), ends "
          f"{(w1 - k1) / 1e3:.1f} us before the wait's end; kernel "
          f"{(k1 - k0) / 1e3:.1f} us, wait {(w1 - w0) / 1e3:.1f} us")
    slack = 50_000
    assert i0 - slack <= k0 < k1 <= w1 + slack
    # the host waited for the kernel, and woke within 0.5 ms of its end
    # (23-62 us on an H100 80GB HBM3)
    assert w0 < k1 and w1 - k1 <= 10 * slack


_DRAW_PROBE = """
import dataclasses, json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch import trace
from repro_torch.core import engine as EN
from repro_torch.launch import train_relief_har as TR
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
runs = {}
for w in ("cpu", "cuda"):  # the same seed: the same windows and rng
    run, ds = TR.build(backbone="b2", small=True, dropout=0.0, device=w)
    runs[w] = EN.FedRun.create(run.task, run.proto, run.strategy, run.fleet,
                               dataclasses.replace(run.fed, local_epochs=1))
card = runs["cuda"]
drawn = {w: r._round_batches(ds) for w, r in runs.items()}
equal = all(torch.equal(drawn["cuda"][k].cpu(), drawn["cpu"][k])
            for k in ("x", "y"))
card.round(ds)  # warm: every kernel and shape
torch.cuda.synchronize(dev)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    card.round(ds)
    torch.cuda.synchronize(dev)
prof.export_chrome_trace(sys.argv[1])  # a copy's bytes, by correlation id
with open(sys.argv[1]) as f:
    nbytes = {e["args"]["correlation"]: e["args"]["bytes"]
              for e in json.load(f)["traceEvents"]
              if e.get("cat") == "gpu_memcpy"}
span = {r.name: r for r in trace.records()
        if r.name in ("fed.draw", "fed.local_update")}
print(json.dumps({
    "equal": equal, "rows": int(drawn["cpu"]["y"].numel()),
    "draw": [span["fed.draw"].start, span["fed.draw"].end,
             span["fed.draw"].attrs],
    "update_start": span["fed.local_update"].start,
    "copies": [[e.name(), e.start_ns(), nbytes.get(e.correlation_id())]
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and "HtoD" in e.name()]}))
"""


def test_round_draws_its_batches_on_the_card(dev, tmp_path):
    """A small B2 relief round on the card, profiled in a fresh process as
    the benchmark traces: the draw gives the CPU draw's batches for the
    same seed; in a round after the one that built the resident windows,
    ``fed.draw`` builds nothing, its ``h2d_bytes`` is the int64 row
    indices' bytes, and no host-to-device copy between the draw's start and
    the local update's is larger than that array (the host gather copied
    every batch)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", _DRAW_PROBE,
                          str(tmp_path / "trace.json")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["equal"]
    d0, _, attrs = got["draw"]
    rows = got["rows"] * 8
    assert attrs == {"built": 0, "h2d_bytes": rows}
    copies = [c for c in got["copies"] if d0 <= c[1] <= got["update_start"]]
    for name, start, size in copies:
        print(f"[draw] {name}: {(start - d0) / 1e3:.1f} us after the draw's "
              f"start, {size} bytes")
    sizes = [c[2] for c in copies]
    assert None not in sizes and sizes.count(rows) == 1, copies
    assert max(sizes) == rows
