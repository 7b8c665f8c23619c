"""The fp32 cohort aggregation (``csrc/cohort_agg.cu`` ``agg_kernel`` over its
fp32 load stage) on the CPU: its split-order plain version against the JAX
reference (the Pallas kernel in interpret mode and the XLA oracle), against
the one-pass plain version at the planner's splits and lanes, and the CPU
dispatch of the op.

``ref.cohort_agg_divergence_split_ref`` sums as the kernel does: the
clients in contiguous splits, each split in client lanes, the row
statistics per row; ``ops.plan_agg`` plans both uplinks. Inputs come from
seeded numpy generators. Tolerance: ATOL = RTOL = 1e-4, as the cohort parity
tests (fp32 sums over the clients in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.cohort_agg import ops as jops  # noqa: E402
from repro_torch.kernels.cohort_agg import ops as c_ops  # noqa: E402
from repro_torch.kernels.cohort_agg import ref as c_ref  # noqa: E402

ATOL = RTOL = 1e-4
SHAPES = [(4, 64, 4), (9, 96, 8), (16, 100, 1), (4, 112, 128)]
# multi-split plans at sms = 1 and 132, and a row wider than a block
PLAN_SHAPES = SHAPES + [(300, 100, 1), (1000, 32, 4), (64, 3, 2048)]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process: torch's CPU ops run 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(N, D, r, seed, empty=False):
    rng = np.random.default_rng(seed)
    W = (rng.random((N, D)) * (rng.random((N, D)) < 0.7)).astype(np.float32)
    C = (rng.random((N, D)) < 0.6).astype(np.float32)
    if empty:
        W[:] = 0.0
        C[:] = 0.0
    x = rng.normal(size=(N, D, r)).astype(np.float32)
    return x, W, C


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("N,D,r", SHAPES)
@pytest.mark.parametrize("empty", [False, True], ids=["cohort", "empty"])
def test_split_plain_matches_reference(N, D, r, empty):
    args = _case(N, D, r, N + D + r, empty)
    jargs = tuple(map(jnp.asarray, args))
    want_p = jops.cohort_agg_divergence(*jargs, impl="pallas", interpret=True)
    want_x = jops.cohort_agg_divergence(*jargs, impl="xla")
    t = tuple(map(torch.from_numpy, args))
    for splits, lanes in ((1, 1), (2, 2), (N, 1), (3, 8)):
        got = c_ref.cohort_agg_divergence_split_ref(*t, splits, lanes)
        _close(got, want_p)
        _close(got, want_x)
        if empty:
            assert (got[0] == 0).all() and (got[3] == 0).all()


@pytest.mark.parametrize("N,D,r", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [1, 132])
def test_split_plain_at_the_plan_matches_plain(N, D, r, sms):
    args = tuple(map(torch.from_numpy, _case(N, D, r, 3 * N + r)))
    plan = c_ops.plan_agg(N, D, r, sms)
    got = c_ref.cohort_agg_divergence_split_ref(*args, plan.splits,
                                                plan.lanes)
    want = c_ref.cohort_agg_divergence_ref(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("N,D,r", PLAN_SHAPES)
def test_quant_split_plain_is_the_fp32_one_with_scalars(N, D, r):
    """Codes with every scale 1 and no discount: the int8 split order is the
    fp32 one on the same values, bit for bit (one body, scalars folded)."""
    rng = np.random.default_rng(N + r)
    _, W, C = map(torch.from_numpy, _case(N, D, r, N))
    q = torch.from_numpy(rng.integers(-127, 128, (N, D, r)).astype(np.int8))
    ones, zeros = torch.ones(N), torch.zeros(N)
    plan = c_ops.plan_agg(N, D, r, 132)
    got = c_ref.cohort_agg_divergence_quant_split_ref(
        q, ones, W, C, zeros, 0.0, plan.splits, plan.lanes)
    want = c_ref.cohort_agg_divergence_split_ref(q.float(), W, C,
                                                 plan.splits, plan.lanes)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cpu_call_reaches_no_counter():
    args = tuple(map(torch.from_numpy, _case(5, 40, 4, 1)))
    before = dict(c_ops.LAUNCHES)
    got = c_ops.cohort_agg_divergence(*args)
    assert c_ops.LAUNCHES == before
    for a, b in zip(got, c_ref.cohort_agg_divergence_ref(*args)):
        assert torch.equal(a, b)
