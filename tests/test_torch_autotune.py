"""The port's launch-plan autotuner (``kernels/cohort_agg/autotune.py``)
and ``ref.divergence_from_stats`` against the JAX reference on the CPU:
the untimed branch of both selectors gives the reference's values
exactly over a sweep of shapes, and the timed branch's candidate plans
are plans the kernels take. The timed sweep itself runs on the card
(``chip_smoke.py`` phase 36)."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.cohort_agg import autotune as JAT  # noqa: E402
from repro.kernels.cohort_agg import ref as jref  # noqa: E402
from repro_torch.kernels.cohort_agg import autotune as TAT  # noqa: E402
from repro_torch.kernels.cohort_agg import ops as agg_ops  # noqa: E402
from repro_torch.kernels.cohort_agg import ref as tref  # noqa: E402
from repro_torch.kernels.mdlora import ops as md_ops  # noqa: E402

AGG_SHAPES = [(4, 112, 128), (4, 112, 8), (64, 112, 8), (9, 100, 1),
              (16, 96, 8), (16384, 1024, 4), (3, 7, 3), (8, 4096, 64),
              (2, 1, 1), (5, 640, 2048)]
MD_SHAPES = [(256, 112, 128, 8), (16, 5120, 5120, 8), (16, 5120, 1280, 8),
             (8, 1600, 320, 8), (1, 7, 5, 3), (512, 4096, 14336, 16),
             (33, 96, 130, 4), (4096, 2048, 2048, 256)]


@pytest.fixture(autouse=True)
def _fresh_caches():
    JAT.clear_cache()
    TAT.clear_cache()
    yield
    JAT.clear_cache()
    TAT.clear_cache()


@pytest.mark.parametrize("D", [1, 7, 64, 96, 100, 112, 128, 1000, 1024,
                               4096, 5120, 17920, 65536])
@pytest.mark.parametrize("cap", [1, 3, 64, 128, 256, 512, 10**6])
def test_largest_divisor_matches_reference(D, cap):
    assert TAT.largest_divisor(D, cap) == JAT.largest_divisor(D, cap)


@pytest.mark.parametrize("N,D,r", AGG_SHAPES)
def test_block_size_untimed_matches_reference(N, D, r):
    """``candidate_bds`` and the untimed branch of ``select_block_size``
    (interpret mode, and the XLA impl) exactly."""
    assert TAT.candidate_bds(D, r) == JAT.candidate_bds(D, r)
    for impl, interpret in (("pallas", True), ("xla", False), ("xla", True)):
        for quant in (False, True):
            got = TAT.select_block_size((N, D, r), impl, interpret, quant)
            want = JAT.select_block_size((N, D, r), impl, interpret, quant)
            assert got == want and isinstance(got, int)


@pytest.mark.parametrize("T,D,F,r", MD_SHAPES)
@pytest.mark.parametrize("multi", [False, True])
def test_mdlora_untimed_matches_reference(T, D, F, r, multi):
    assert (TAT.mdlora_candidates(T, D, F, r, multi)
            == [tuple(c) for c in JAT.mdlora_candidates(T, D, F, r, multi)])
    for impl, interpret in (("pallas", True), ("xla", False)):
        got = TAT.select_mdlora_blocks((T, D, F, r), impl, interpret, multi,
                                       n_adapters=16)
        want = JAT.select_mdlora_blocks((T, D, F, r), impl, interpret, multi,
                                        n_adapters=16)
        assert tuple(got) == tuple(want)


def test_cache_is_kept_and_cleared():
    TAT.select_block_size((4, 112, 128))
    assert TAT._CACHE
    TAT.clear_cache()
    assert not TAT._CACHE and not TAT.TIMINGS


def test_timed_branch_needs_the_card():
    """The timed branch sweeps the CUDA kernels: without a card it raises,
    as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TAT.select_block_size((4, 112, 128), interpret=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TAT.select_mdlora_blocks((256, 112, 128, 8), interpret=False)


def _plan_ok(N, D, r, p) -> bool:
    """``csrc/cohort_agg.cu`` ``bad_plan``'s rule, negated."""
    ts = agg_ops.AGG_THREADS // p.lanes
    return (p.vec in (1, 4) and r % p.vec == 0 and 1 <= p.lanes <= 8
            and p.lanes & (p.lanes - 1) == 0 and 1 <= p.rows <= ts
            and (p.rows == 1 or p.rows * (r // p.vec) <= ts)
            and p.splits >= 1)


@pytest.mark.parametrize("N,D,r", AGG_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_agg_candidates_are_plans_the_kernel_takes(N, D, r, sms):
    cands = TAT.agg_candidates(N, D, r, sms)
    assert agg_ops.plan_agg(N, D, r, sms) in cands
    assert len(set(cands)) == len(cands) <= 13
    for p in cands:
        assert _plan_ok(N, D, r, p), p
        # each lane keeps at least MIN_LANE_CLIENTS clients per split,
        # unless a single split
        assert p.splits == 1 or -(-N // p.splits) >= p.lanes


@pytest.mark.parametrize("D,F", [(5120, 5120), (5120, 1280), (1600, 320),
                                 (4096, 14336), (112, 128), (65, 7)])
@pytest.mark.parametrize("sms", [132, 8])
def test_multi_candidates_are_plans_the_kernel_takes(D, F, sms):
    """bf16: L a multiple of STAGE_K, sd = ceil(D / L), su = ceil(D /
    U_LEN), ug in {4, 16} (``launch_bf16``'s checks); fp32: su as
    ``_plan``'s. The default plan is among them."""
    bf16 = TAT.multi_candidates(D, F, 8, sms, torch.bfloat16)
    assert md_ops.plan_multi(D, F, sms) in bf16
    for L, sd, su, ug in bf16:
        assert L >= md_ops.STAGE_K and L % md_ops.STAGE_K == 0
        assert sd == -(-D // L) and su == -(-D // md_ops.U_LEN)
        assert ug in (4, 16)


@pytest.mark.parametrize("tiles,default,sms", [(32, 32, 132), (1600, 264, 132),
                                               (4, 4, 8), (10**5, 528, 132)])
def test_fused_candidates(tiles, default, sms):
    cands = TAT.fused_candidates(tiles, default, sms)
    assert default in cands and tiles in cands
    assert all(1 <= c <= tiles for c in cands) and cands == sorted(set(cands))


def test_ops_take_a_plan_on_the_cpu():
    """``plan=`` is the kernels' launch plan: the plain versions (CPU
    tensors) ignore it and give the same values."""
    g = np.random.default_rng(0)
    x = torch.as_tensor(g.normal(size=(4, 16, 8)), dtype=torch.float32)
    W = torch.as_tensor(g.random((4, 16)), dtype=torch.float32)
    C = torch.as_tensor(g.random((4, 16)) < 0.5, dtype=torch.float32)
    plan = agg_ops.AggPlan(4, 2, 2, 1)
    for a, b in zip(agg_ops.cohort_agg_divergence(x, W, C, plan=plan),
                    agg_ops.cohort_agg_divergence(x, W, C)):
        assert torch.equal(a, b)
    xm, w0 = torch.randn(3, 16), torch.randn(16, 8)
    a, b = torch.randn(2, 16, 4), torch.randn(2, 4, 8)
    idx = torch.tensor([0, 1, 1], dtype=torch.int32)
    assert torch.equal(
        md_ops.mdlora_matmul_multi(xm, w0, a, b, idx, plan=(64, 1, 1, 4)),
        md_ops.mdlora_matmul_multi(xm, w0, a, b, idx))
    assert torch.equal(md_ops.mdlora_matmul(xm, w0, a[0], b[0], None, 2.0,
                                            plan=7),
                       md_ops.mdlora_matmul(xm, w0, a[0], b[0], None, 2.0))


@pytest.mark.parametrize("D,n_blocks,empty_rows", [(32, 2, 0), (112, 4, 5),
                                                   (100, 7, 0), (9, 1, 9)])
def test_divergence_from_stats_matches_reference(D, n_blocks, empty_rows):
    """Eq. 5's per-block divergence from the row statistics, at 1e-6
    relative (the block sums add in another order than the reference's
    scatter-add); rows with an empty cohort give 0."""
    g = np.random.default_rng(D + n_blocks)
    r = 4
    sq = (g.random(D) * 5).astype(np.float32)
    mean = g.normal(size=(D, r)).astype(np.float32) * 0.3
    cnt = g.integers(0, 5, D).astype(np.float32)
    cnt[:empty_rows] = 0.0
    ids = np.sort(g.integers(0, n_blocks, D)).astype(np.int32)
    want = np.asarray(jref.divergence_from_stats(
        jnp.asarray(sq), jnp.asarray(mean), jnp.asarray(cnt),
        jnp.asarray(ids), n_blocks))
    got = tref.divergence_from_stats(torch.as_tensor(sq),
                                     torch.as_tensor(mean),
                                     torch.as_tensor(cnt),
                                     torch.as_tensor(ids), n_blocks)
    assert got.dtype == torch.float32 and got.shape == (n_blocks,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max() + 1))
    assert math.isfinite(float(got.sum()))
