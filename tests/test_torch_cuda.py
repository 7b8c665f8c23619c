"""The CUDA kernels (cohort aggregation, flash attention, gathered
multi-LoRA) against their plain PyTorch versions, on the card. Marked
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
    assert ops.split_count(4096, 112, 4, dev) > 1  # the two-stage path
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


# ---------------------------------------------------------------------------
# gathered multi-LoRA
# ---------------------------------------------------------------------------

# fp32 sums over D in another order; bf16: x, W0 and the output are bf16
MD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2e-2)}


def _md_inputs(B, D, F, r, A, dtype, dev, seed, blocks=2):
    g = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    x = t(g.normal(size=(B, D)).astype(np.float32)).to(dtype)
    w0 = t((g.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)).to(dtype)
    a = t((g.normal(size=(A, D, r)) / np.sqrt(D)).astype(np.float32))
    b = t((0.05 * g.normal(size=(A, r, F))).astype(np.float32))
    idx = t(g.integers(0, A, B).astype(np.int32))
    mm = (g.random((B, blocks)) < 0.7).astype(np.float32)
    mask = md_ops.block_row_masks([D // blocks] * blocks, mm).to(dev)
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


def test_cpu_tensors_never_reach_a_launch_counter(dev):
    before = (dict(fa_ops.LAUNCHES), dict(md_ops.LAUNCHES))
    cpu = torch.device("cpu")
    fa_ops.flash_attention(*_fa_inputs(1, 4, 8, 1, 2, 16, torch.float32,
                                       cpu, 0))
    md_ops.mdlora_matmul_multi(*_md_inputs(2, 32, 16, 4, 2, torch.float32,
                                           cpu, 0), scale=2.0)
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
