"""The sum orders of the two tensor-core kernels, on the CPU: the plain
versions that follow them against the JAX reference (its Pallas kernels in
interpret mode and its XLA paths), and their planners.

* The gathered multi-LoRA projection in bf16 (``csrc/mdlora_multi.cu``)
  sums its base product over D splits of ``ops.plan_multi``'s length and
  the bottleneck over ``ops.U_LEN``-wide splits:
  ``ref.mdlora_matmul_multi_split_ref``.
* The SSD chunk walk in bf16 (``csrc/ssd.cu``) walks p in 32-column slices
  and folds dt into its derived operands, each fed to the tensor cores as a
  bf16 hi + lo pair: ``ref.ssd_walk_ref``.

Inputs come from seeded numpy generators. Tolerances: fp32 sums in another
order, 1e-4 (as the existing parity tests of both ops); the hi + lo operands
move each product term by at most 2^-16 of it per rounded operand, so the
hi + lo walk stays within 2^-14 of the same walk over absolute values.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.mdlora import ops as jmd  # noqa: E402
from repro.kernels.mdlora.kernel import mdlora_matmul_multi_pallas  # noqa: E402
from repro.kernels.ssd.ops import ssd as j_ssd  # noqa: E402
from repro_torch.kernels.mdlora import ops as md_ops  # noqa: E402
from repro_torch.kernels.mdlora import ref as md_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402

MD_ATOL = SSD_ATOL = 1e-4
HI_LO_RTOL = 2.0**-14  # of the walk over absolute values


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process: torch's CPU ops run 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the gathered multi-LoRA projection: split-D order and its planner
# ---------------------------------------------------------------------------


def _md_case(B, D, F, r, A, seed, blocks=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    w0 = (rng.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)
    a = (rng.normal(size=(A, D, r)) / np.sqrt(D)).astype(np.float32)
    b = (0.1 * rng.normal(size=(A, r, F))).astype(np.float32)
    idx = rng.integers(0, A, B).astype(np.int32)
    dims = [D // blocks] * (blocks - 1) + [D - (blocks - 1) * (D // blocks)]
    mm = (rng.random((B, blocks)) < 0.7).astype(np.float32)
    return x, w0, a, b, idx, dims, mm


def _block(n):
    """The Pallas kernel's tile along an axis: 256, or the whole axis when
    256 does not divide it."""
    return 256 if n % 256 == 0 else n


@pytest.mark.parametrize("B,D,F,r,A", [
    (8, 256, 128, 4, 3), (16, 300, 77, 8, 16), (33, 512, 96, 8, 4),
    (5, 1600, 64, 8, 2),
])
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_md_split_plain_matches_pallas_and_xla(B, D, F, r, A, sms):
    x, w0, a, b, idx, dims, mm = _md_case(B, D, F, r, A, B + D + F + sms)
    masks_j = jmd.block_row_masks(dims, mm)
    masks_t = md_ops.block_row_masks(dims, mm)
    L, sd, su, ug = md_ops.plan_multi(D, F, sms)
    t = [torch.from_numpy(z) for z in (x, w0, a, b, idx)]
    got = md_ref.mdlora_matmul_multi_split_ref(*t, masks_t, 2.0, L,
                                               md_ops.U_LEN).numpy()
    jargs = (*map(jnp.asarray, (x, w0, a, b)), jnp.asarray(idx), masks_j)
    pallas = mdlora_matmul_multi_pallas(*jargs, 2.0, bf=_block(F),
                                        bd=_block(D), interpret=True)
    xla = jmd.mdlora_matmul_multi(*jargs, scale=2.0, impl="xla")
    for want in (pallas, xla):
        np.testing.assert_allclose(got, _np(want), atol=MD_ATOL,
                                   rtol=MD_ATOL)


@pytest.mark.parametrize("L", [64, 128, 448, 2048])
def test_md_split_plain_in_bf16_matches_the_one_pass_plain(L):
    """bf16 x and W0: rounding x*m to bf16 (exact for 0/1 masks) and the
    split order change no more than the bf16 output's rounding; a
    fractional mask rounds x*m once more (2^-9 of an element)."""
    x, w0, a, b, idx, dims, mm = _md_case(16, 640, 192, 8, 4, L)
    t = [torch.from_numpy(z) for z in (x, w0, a, b, idx)]
    t[0], t[1] = t[0].bfloat16(), t[1].bfloat16()
    for m in (mm, mm * 0.37 + 0.2):
        mask = md_ops.block_row_masks(dims, m)
        got = md_ref.mdlora_matmul_multi_split_ref(*t, mask, 2.0, L,
                                                   md_ops.U_LEN)
        want = md_ref.mdlora_matmul_multi_ref(*t, mask, 2.0)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=2e-2)
    exact = md_ref.mdlora_matmul_multi_split_ref(
        *t, md_ops.block_row_masks(dims, mm), 2.0, 640, 640)
    torch.testing.assert_close(
        exact, md_ref.mdlora_matmul_multi_ref(
            *t, md_ops.block_row_masks(dims, mm), 2.0), atol=2e-2, rtol=0)


@pytest.mark.parametrize("D", [1, 63, 64, 300, 1600, 4800, 5120, 70000])
@pytest.mark.parametrize("F", [1, 77, 320, 1280, 1600, 5120, 40000])
@pytest.mark.parametrize("sms", [1, 114, 132])
def test_md_planner_reads_the_shape_and_card_only(D, F, sms):
    """L is a whole number of ring stages, at least MIN_STAGES where D
    allows; sd splits of L cover D with none empty; all blocks fit the
    card at once unless the shortest splits are already too many; the
    bottleneck takes 4-row groups only where they fit too. The planner
    takes no batch argument, so a row's sums cannot depend on B."""
    L, sd, su, ug = md_ops.plan_multi(D, F, sms)
    assert L % md_ops.STAGE_K == 0 and L >= md_ops.STAGE_K
    assert (sd - 1) * L < D <= sd * L
    assert su == -(-D // md_ops.U_LEN)
    n_ft = -(-F // md_ops.TILE_F)
    assert L >= min(md_ops.MIN_STAGES * md_ops.STAGE_K, D)
    if L > md_ops.MIN_STAGES * md_ops.STAGE_K:
        assert su + n_ft * sd <= max(md_ops.BLOCKS_PER_SM * sms, su + n_ft)
    assert ug == (4 if 4 * su + n_ft * sd <= md_ops.BLOCKS_PER_SM * sms
                  else 16)


# ---------------------------------------------------------------------------
# the SSD chunk walk: p slices, folded dt, hi + lo operands
# ---------------------------------------------------------------------------


def _ssd_case(b, s, h, p, n, seed, a_shift=0.0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(f)  # softplus
    A_log = (rng.normal(size=h) + a_shift).astype(f)
    Bm = rng.normal(size=(b, s, n)).astype(f)
    Cm = rng.normal(size=(b, s, n)).astype(f)
    return x, dt, A_log, Bm, Cm


def _t(x):
    return torch.from_numpy(np.asarray(x))


SSD_WALK_CASES = [  # s, h, p, n, chunk, bh (Pallas heads per block)
    (64, 4, 16, 8, 16, 2), (128, 8, 8, 16, 32, 8), (32, 2, 32, 4, 32, 1),
    (64, 2, 40, 8, 16, 2),  # two p slices, the second 8 wide
    (64, 4, 64, 16, 64, 4),  # hymba's head (p 64, n 16) at one chunk
]


@pytest.mark.parametrize("s,h,p,n,chunk,bh", SSD_WALK_CASES)
def test_ssd_walk_plain_matches_pallas_and_xla(s, h, p, n, chunk, bh):
    args = _ssd_case(2, s, h, p, n, s + h + p + n)
    y, fs = ssd_ref.ssd_walk_ref(*map(_t, args), chunk)
    jargs = list(map(jnp.asarray, args))
    yp, fp = j_ssd(*jargs, chunk=chunk, impl="pallas", interpret=True, bh=bh)
    yx, fx = j_ssd(*jargs, chunk=chunk, impl="xla")
    for want_y, want_f in ((yp, fp), (yx, fx)):
        np.testing.assert_allclose(y.numpy(), _np(want_y), atol=SSD_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(fs.numpy(), _np(want_f), atol=SSD_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("s,h,p,n,chunk,bh", SSD_WALK_CASES)
def test_ssd_walk_hi_lo_stays_within_its_rounding(s, h, p, n, chunk, bh):
    """The hi + lo operands against the same walk in fp32, bounded by the
    walk over |x|, |B| and |C| (every term's magnitude)."""
    args = list(map(_t, _ssd_case(2, s, h, p, n, 7 * s + p)))
    exact = ssd_ref.ssd_walk_ref(*args, chunk)
    split = ssd_ref.ssd_walk_ref(*args, chunk, hi_lo=True)
    x, dt, A_log, Bm, Cm = args
    scale = ssd_ref.ssd_walk_ref(x.abs(), dt, A_log, Bm.abs(), Cm.abs(),
                                 chunk)
    for a, e, S in zip(split, exact, scale):
        assert ((a - e).abs() <= HI_LO_RTOL * S + 1e-6).all()
    assert not torch.equal(split[0], exact[0])  # the rounding is there


def test_ssd_walk_with_initial_state_matches_xla():
    """The walk starts from a carried state, as the kernel now does; slow
    decays (A = exp(A_log) ~ 0.05) keep it in y to the last chunk."""
    x, dt, A_log, Bm, Cm = _ssd_case(2, 64, 4, 40, 8, 3, a_shift=-3.0)
    s0 = np.random.default_rng(4).normal(size=(2, 4, 40, 8)).astype(
        np.float32)
    jargs = [jnp.asarray(v) for v in (x, dt, A_log, Bm, Cm)]
    yx, fx = j_ssd(*jargs, chunk=16, initial_state=jnp.asarray(s0),
                   impl="xla")
    y0, _ = j_ssd(*jargs, chunk=16, impl="xla")
    assert np.abs(_np(yx) - _np(y0))[:, -16:].max() > 1e-2
    for hi_lo in (False, True):
        y, fs = ssd_ref.ssd_walk_ref(*map(_t, (x, dt, A_log, Bm, Cm)), 16,
                                     initial_state=_t(s0), hi_lo=hi_lo)
        tol = SSD_ATOL * (10 if hi_lo else 1)
        np.testing.assert_allclose(y.numpy(), _np(yx), atol=tol, rtol=0)
        np.testing.assert_allclose(fs.numpy(), _np(fx), atol=tol, rtol=0)


@pytest.mark.parametrize("p_block", [8, 16, 32, 64])
def test_ssd_walk_p_slices_are_independent(p_block):
    """Each p slice walks with its own state and the same scores: any
    slice width gives the same result as one slice over all of p."""
    args = list(map(_t, _ssd_case(1, 48, 3, 64, 8, 9)))
    one = ssd_ref.ssd_walk_ref(*args, 16, p_block=64)
    got = ssd_ref.ssd_walk_ref(*args, 16, p_block=p_block)
    for a, b in zip(got, one):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_ssd_cpu_call_with_initial_state_reaches_no_counter():
    args = list(map(_t, _ssd_case(1, 32, 2, 8, 4, 1)))
    before = dict(ssd_ops.LAUNCHES)
    y, fs = ssd_ops.ssd(*args, 16, initial_state=torch.ones(1, 2, 8, 4))
    assert ssd_ops.LAUNCHES == before
    want = ssd_ref.ssd_ref(*args, 16, torch.ones(1, 2, 8, 4))
    assert torch.equal(y, want[0]) and torch.equal(fs, want[1])
