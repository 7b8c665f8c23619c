"""The arithmetic of the two kernels redesigned for Hopper, on the CPU: the
plain versions that follow them against the JAX reference (its Pallas
kernels in interpret mode and its jnp oracles), and the aggregation's
planner.

* The fused block-LoRA projection (``csrc/mdlora.cu``) runs its fp32 products
  on the tensor cores as 3xTF32: ``ref.mdlora_matmul_tf32x3_ref`` (with
  ``ref.tf32_rna``, the ``cvt.rna.tf32.f32`` rounding) at the shapes of
  ``chip_smoke.py``'s FUSED_CASES, 1024 clients cut to 64.
* The int8 cohort aggregation (``csrc/cohort_agg.cu`` ``agg_kernel``) sums
  per split and per client lane, with the row statistics per row:
  ``ref.cohort_agg_divergence_quant_split_ref``, planned by
  ``ops.plan_agg``.

Inputs come from seeded numpy generators. Tolerances: FUSED_TOL (1e-4 atol
and rtol, fp32 sums over D = 112 in another order; 3xTF32 leaves ~2^-21 of
each term), the bf16 projection's (2e-2, 2^-8: y rounded once to bf16), and
the cohort parity tests' ATOL = RTOL = 1e-4.
"""
import inspect
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.cohort_agg import ops as jops  # noqa: E402
from repro.kernels.mdlora import ref as j_md  # noqa: E402
from repro.kernels.mdlora.kernel import mdlora_matmul_pallas  # noqa: E402
from repro_torch.kernels.cohort_agg import ops as c_ops  # noqa: E402
from repro_torch.kernels.cohort_agg import ref as c_ref  # noqa: E402
from repro_torch.kernels.mdlora import ref as md_ref  # noqa: E402
from repro_torch.sim import make_fleet  # noqa: E402

FUSED_TOL = {False: (1e-4, 1e-4), True: (2e-2, 2**-8)}  # by bf16?
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process: torch's CPU ops run 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# cvt.rna.tf32.f32
# ---------------------------------------------------------------------------


def _f(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


@pytest.mark.parametrize("bits,want", [
    (0x3F801000, 0x3F802000),  # 1 + 2^-11: a tie, away from zero
    (0xBF801000, 0xBF802000),  # the same below zero
    (0x3F803000, 0x3F804000),  # 1 + 3 2^-11: a tie, away (not to even)
    (0x3F800FFF, 0x3F800000),  # just below half: down
    (0x3F801001, 0x3F802000),  # just above half: up
    (0x40400000, 0x40400000),  # 3.0, exact
    (0x3F802000, 0x3F802000),  # a TF32 value stays
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0
    (0x7F800000, 0x7F800000),  # inf
    (0x00001000, 0x00002000),  # a subnormal tie
], ids=["tie", "tie-neg", "tie-odd", "below", "above", "exact", "tf32",
        "zero", "neg-zero", "inf", "subnormal"])
def test_tf32_rna_rounds_as_cvt_rna(bits, want):
    got = md_ref.tf32_rna(torch.tensor([_f(bits)]))
    assert got.view(torch.int32).item() & 0xFFFFFFFF == want


def test_tf32_rna_keeps_nan_and_matches_frexp_rounding():
    assert torch.isnan(md_ref.tf32_rna(torch.tensor([float("nan")]))).all()
    v = np.random.default_rng(0).normal(size=4096).astype(np.float32) * \
        np.float32(10.0) ** np.random.default_rng(1).integers(-6, 6, 4096)
    m, e = np.frexp(v.astype(np.float64))  # |m| in [0.5, 1): 11 bits kept
    want = np.sign(m) * np.floor(np.abs(m) * 2**11 + 0.5) / 2**11 * 2.0**e
    got = md_ref.tf32_rna(torch.from_numpy(v)).double().numpy()
    np.testing.assert_array_equal(got, want)
    lo = v - got.astype(np.float32)  # the hi + lo split is exact to ~2^-22
    rest = v - got - md_ref.tf32_rna(torch.from_numpy(lo)).double().numpy()
    assert (np.abs(rest) <= 2.0**-21 * np.abs(v)).all()


# ---------------------------------------------------------------------------
# the fused projection in 3xTF32
# ---------------------------------------------------------------------------

PAMAP2_BLOCKS = [32, 32, 32, 16]
# chip_smoke.py's FUSED_CASES: label, K (None: one evaluation batch), T, D,
# F, r; 1024 clients cut to 64
FUSED_CASES = [
    ("path", 8, 32, 112, 128, 8),
    ("eval", None, 256, 112, 128, 8),
    ("ragged", 3, 37, 100, 70, 5),
    ("64 clients", 64, 32, 112, 128, 8),
]


def _fused_case(K, T, D, F, r, seed):
    """W0 [D, F] shared; per-client x, a, b and the paper fleet's modality
    masks, over PAMAP2's blocks (D = 112) or four blocks of D."""
    g = np.random.default_rng(seed)
    lead = () if K is None else (K,)
    x = g.normal(size=lead + (T, D)).astype(np.float32)
    w0 = (g.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)
    a = (g.normal(size=lead + (D, r)) / np.sqrt(D)).astype(np.float32)
    b = (0.05 * g.normal(size=lead + (r, F))).astype(np.float32)
    blocks = PAMAP2_BLOCKS if D == 112 else [D - 3 * (D // 4)] + [D // 4] * 3
    mm = make_fleet(3, 3, 2, M=4).modality_mask.astype(np.float32)
    mm = mm[np.arange(K or 1) % mm.shape[0]]
    mask = np.repeat(mm, blocks, axis=1)
    return x, w0, a, b, mask if K is not None else mask[0]


def _jax_fused(x, w0, a, b, mask, pallas):
    def one(x_, a_, b_, m_):
        if pallas:
            return mdlora_matmul_pallas(x_, jnp.asarray(w0), a_, b_, m_, 2.0,
                                        interpret=True)
        return j_md.mdlora_matmul_ref(x_, jnp.asarray(w0), a_, b_, m_, 2.0)
    if x.ndim == 2:
        return one(*map(jnp.asarray, (x, a, b, mask)))
    return jax.vmap(one)(*map(jnp.asarray, (x, a, b, mask)))


@pytest.mark.parametrize("label,K,T,D,F,r", FUSED_CASES,
                         ids=[c[0] for c in FUSED_CASES])
@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "jnp"])
def test_tf32x3_plain_matches_reference(label, K, T, D, F, r, pallas):
    x, w0, a, b, mask = _fused_case(K, T, D, F, r, T + D + F + r)
    got = md_ref.mdlora_matmul_tf32x3_ref(
        *map(torch.from_numpy, (x, w0, a, b, mask)), 2.0)
    want = np.asarray(_jax_fused(x, w0, a, b, mask, pallas), np.float32)
    atol, rtol = FUSED_TOL[False]
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("label,K,T,D,F,r", FUSED_CASES,
                         ids=[c[0] for c in FUSED_CASES])
def test_tf32x3_plain_ignores_poisoned_absent_rows(label, K, T, D, F, r):
    """Rows of absent blocks poisoned with 1e4: x*m is exactly 0 there, so
    both TF32 halves are 0 and y is the same bits."""
    x, w0, a, b, mask = _fused_case(K, T, D, F, r, 7 * T + D)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    mask_t = np.expand_dims(mask, -2)
    y = md_ref.mdlora_matmul_tf32x3_ref(t(x), t(w0), t(a), t(b), t(mask), 2.)
    poisoned = x + (1.0 - mask_t) * np.float32(1e4)
    y2 = md_ref.mdlora_matmul_tf32x3_ref(t(poisoned.astype(np.float32)),
                                         t(w0), t(a), t(b), t(mask), 2.)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("label,K,T,D,F,r", FUSED_CASES,
                         ids=[c[0] for c in FUSED_CASES])
def test_tf32x3_split_is_closer_than_one_tf32_product(label, K, T, D, F, r):
    """3xTF32 leaves ~2^-21 of each term: against fp64 it stays within
    2^-18 of the sum over |terms|, where hi * hi alone does not."""
    x, w0, a, b, mask = _fused_case(K, T, D, F, r, D + r)
    t = [torch.from_numpy(v) for v in (x, w0, a, b, mask)]
    got = md_ref.mdlora_matmul_tf32x3_ref(*t, 2.0).double()
    exact = md_ref.mdlora_matmul_ref(*[v.double() for v in t], 2.0)
    scale = md_ref.mdlora_matmul_ref(*[v.double().abs() for v in t], 2.0)
    assert ((got - exact).abs() <= 2.0**-18 * scale + 1e-12).all()
    one = md_ref.mdlora_matmul_ref(md_ref.tf32_rna(t[0]),
                                   md_ref.tf32_rna(t[1]),
                                   md_ref.tf32_rna(t[2]), t[3], t[4], 2.0)
    assert ((one.double() - exact).abs() > 2.0**-18 * scale).any()


@pytest.mark.parametrize("label,K,T,D,F,r", FUSED_CASES,
                         ids=[c[0] for c in FUSED_CASES])
def test_tf32x3_plain_in_bf16_matches_the_plain_version(label, K, T, D, F,
                                                        r):
    """bf16 operands are exact in TF32 (lo = 0) and 0/1 masks keep x*m
    exact: only the sums' order and y's bf16 rounding are left."""
    x, w0, a, b, mask = _fused_case(K, T, D, F, r, F + r)
    t = [torch.from_numpy(v).bfloat16() for v in (x, w0, a, b)]
    m = torch.from_numpy(mask)
    got = md_ref.mdlora_matmul_tf32x3_ref(*t, m, 2.0)
    assert got.dtype == torch.bfloat16
    want = md_ref.mdlora_matmul_ref(*t, m, 2.0)
    atol, rtol = FUSED_TOL[True]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_tf32x3_plain_broadcasts_every_operand():
    """W0 batched and the adapters shared (the other stride-0 layout the
    kernel takes) give the per-slice results."""
    x, w0, a, b, mask = _fused_case(4, 16, 64, 64, 1, 5)
    w0s = np.stack([w0 * (1 + k) for k in range(4)])
    t = torch.from_numpy
    got = md_ref.mdlora_matmul_tf32x3_ref(t(x), t(w0s), t(a[0]), t(b[0]),
                                          t(mask), 2.0)
    for k in range(4):
        one = md_ref.mdlora_matmul_tf32x3_ref(t(x[k]), t(w0s[k]), t(a[0]),
                                              t(b[0]), t(mask[k]), 2.0)
        assert torch.equal(got[k], one)


# ---------------------------------------------------------------------------
# the int8 cohort aggregation: split order and planner
# ---------------------------------------------------------------------------


def _quant_case(N, D, r, seed, empty=False):
    rng = np.random.default_rng(seed)
    W = (rng.random((N, D)) * (rng.random((N, D)) < 0.7)).astype(np.float32)
    C = (rng.random((N, D)) < 0.6).astype(np.float32)
    if empty:
        W[:] = 0.0
        C[:] = 0.0
    q = rng.integers(-127, 128, (N, D, r)).astype(np.int8)
    scales = rng.uniform(1e-3, 1e-1, N).astype(np.float32)
    staleness = rng.integers(0, 6, N).astype(np.float32)
    return q, scales, W, C, staleness


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)


QUANT_SHAPES = [(4, 64, 4), (9, 96, 8), (16, 100, 1), (4, 112, 128)]


@pytest.mark.parametrize("N,D,r", QUANT_SHAPES)
@pytest.mark.parametrize("exponent", [0.0, 0.5])
@pytest.mark.parametrize("empty", [False, True], ids=["cohort", "empty"])
def test_quant_split_plain_matches_reference(N, D, r, exponent, empty):
    args = _quant_case(N, D, r, N + D + r, empty)
    jargs = tuple(map(jnp.asarray, args))
    want_p = jops.cohort_agg_divergence_quant(*jargs, exponent=exponent,
                                              impl="pallas", interpret=True)
    want_x = jops.cohort_agg_divergence_quant(*jargs, exponent=exponent,
                                              impl="xla")
    t = tuple(map(torch.from_numpy, args))
    for splits, lanes in ((1, 1), (2, 2), (N, 1), (3, 8)):
        got = c_ref.cohort_agg_divergence_quant_split_ref(
            *t, exponent, splits, lanes)
        _close(got, want_p)
        _close(got, want_x)
        if empty:
            assert (got[0] == 0).all() and (got[3] == 0).all()


@pytest.mark.parametrize("N,D,r", QUANT_SHAPES + [(300, 100, 1),
                                                  (1000, 32, 4)])
@pytest.mark.parametrize("sms", [1, 132])
def test_quant_split_plain_at_the_plan_matches_plain(N, D, r, sms):
    """At the planner's (splits, lanes), including multi-split plans."""
    args = tuple(map(torch.from_numpy, _quant_case(N, D, r, 3 * N + r)))
    plan = c_ops.plan_agg(N, D, r, sms)
    got = c_ref.cohort_agg_divergence_quant_split_ref(
        *args, 0.5, plan.splits, plan.lanes)
    want = c_ref.cohort_agg_divergence_quant_ref(*args, 0.5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("N", [1, 3, 4, 9, 300, 4096, 16384])
@pytest.mark.parametrize("D,r", [(1, 1), (112, 128), (100, 1), (96, 8),
                                 (1024, 4), (7, 1000), (3, 2048),
                                 (5, 6), (64, 12)])
@pytest.mark.parametrize("sms", [1, 114, 132])
def test_quant_planner_properties(N, D, r, sms):
    """Tiles cover every row once; a tile's spans fit the span threads
    unless it is one row (walked in passes); lanes a power of two no larger
    than N needs; S >= 1; all blocks resident at once where D allows."""
    plan = c_ops.plan_agg(N, D, r, sms)
    assert plan == c_ops.plan_agg(N, D, r, sms)
    assert plan.vec == (4 if r % 4 == 0 else 1)
    ts = c_ops.AGG_THREADS // plan.lanes
    assert ts >= 32 and ts * plan.lanes == c_ops.AGG_THREADS
    assert plan.lanes & (plan.lanes - 1) == 0
    assert plan.lanes <= max(1, 2 ** math.ceil(math.log2(N)))
    assert 1 <= plan.rows <= D
    assert (plan.tiles(D) - 1) * plan.rows < D <= plan.tiles(D) * plan.rows
    assert plan.rows == 1 or plan.rows * (r // plan.vec) <= ts
    assert plan.splits >= 1
    slots = c_ops.AGG_BLOCKS_PER_SM * sms
    if plan.tiles(D) <= slots:
        assert plan.blocks(D) <= slots
    if plan.splits > 1:  # each lane keeps its share of clients
        assert plan.splits * plan.lanes * c_ops.MIN_LANE_CLIENTS <= \
            N + plan.lanes * c_ops.MIN_LANE_CLIENTS


def test_quant_planner_reads_the_shape_and_card_only():
    assert list(inspect.signature(c_ops.plan_agg).parameters) == [
        "N", "D", "r", "sms"]
    path = c_ops.plan_agg(4, 112, 128, 132)
    assert path.blocks(112) > 14 and path.splits == 1
    fleet = c_ops.plan_agg(16384, 1024, 4, 132)
    assert fleet.splits > 1 and fleet.blocks(1024) <= 4 * 132


def test_quant_cpu_call_reaches_no_counter():
    args = tuple(map(torch.from_numpy, _quant_case(5, 40, 4, 1)))
    before = dict(c_ops.LAUNCHES)
    got = c_ops.cohort_agg_divergence_quant(*args, exponent=0.5)
    assert c_ops.LAUNCHES == before
    want = c_ref.cohort_agg_divergence_quant_ref(*args, 0.5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
