"""The CUDA cohort-agg kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: each test skips without a card, and the file imports
no JAX so it runs on a machine that has only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.cohort_agg import ops, ref  # noqa: E402

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
