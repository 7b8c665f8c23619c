"""The split-KV algorithm of the bf16 decode kernel, on the CPU: its plain
version (``ref.flash_attention_split_ref``) against the JAX Pallas kernel in
interpret mode and the XLA oracle, and the split planner (``ops.plan_splits``).
Inputs come from seeded numpy generators. Tolerance 2e-5, as the one-pass
plain version's parity (fp32 sums in another order); rows that see no key
are compared with the Pallas kernel alone, since the oracle gives the mean
of v there and the kernels give 0.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as j_fa_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402

I32MAX = np.iinfo(np.int32).max
FA_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process: torch's CPU ops run 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(seed, B, S, T, K, G, hd, filled, qpos=None, shift=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, K, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    kvpos = np.where(np.arange(T) < filled, np.arange(T) + shift,
                     -1).astype(np.int32)
    rng.shuffle(kvpos)  # a ring: slots in no order
    if qpos is None:
        qpos = np.arange(filled - S, filled) + shift
    return q, k, v, np.asarray(qpos, np.int32), kvpos


def _split(args, window, softcap, n_split):
    t = [torch.from_numpy(a) for a in args]
    return fa_ref.flash_attention_split_ref(*t, window, softcap,
                                            n_split).numpy()


def _jax(args, window, softcap):
    q, k, v, qpos, kvpos = (jnp.asarray(a) for a in args)
    w = I32MAX if window is None else window
    pallas = flash_attention_pallas(q, k, v, qpos, kvpos, w, softcap,
                                    bq=q.shape[1], bt=k.shape[1],
                                    interpret=True)
    return (np.asarray(pallas, np.float32),
            np.asarray(j_fa_ref(q, k, v, qpos, kvpos, w, softcap), np.float32))


@pytest.mark.parametrize("T,filled,S,G,window,softcap,splits", [
    (200, 150, 1, 4, None, None, (1, 2, 3, 4, 9)),  # ring decode, -1 slots
    (197, 197, 2, 5, None, None, (2, 3)),           # 4 tiles, no even split
    (300, 290, 1, 8, 40, 30.0, (1, 3, 5)),          # window and softcap
    (90, 60, 4, 2, None, None, (1, 2, 7)),          # 2 tiles; 7 > tiles
], ids=["ring_decode", "ragged_T", "window_softcap", "more_splits"])
def test_split_plain_matches_pallas_and_oracle(T, filled, S, G, window,
                                               softcap, splits):
    args = _case(T + S + G, 2, S, T, 2, G, 32, filled)
    pallas, oracle = _jax(args, window, softcap)
    for n in splits:
        got = _split(args, window, softcap, n)
        np.testing.assert_allclose(got, pallas, atol=FA_ATOL, rtol=0,
                                   err_msg=f"n_split={n}")
        np.testing.assert_allclose(got, oracle, atol=FA_ATOL, rtol=0,
                                   err_msg=f"n_split={n}")


def test_split_plain_empty_chunks_and_rows_as_the_pallas_kernel():
    """A window of 20 over 250 cached positions leaves most chunks with no
    visible key for any row; rows 0-2 (before every cached position) and
    row 7 (past the window) see none at all and give 0."""
    qpos = [0, 3, 9, 10, 100, 200, 259, 400]
    args = _case(11, 2, 8, 256, 2, 2, 16, 250, qpos=qpos, shift=10)
    pallas, _ = _jax(args, 20, None)
    for n in (1, 2, 4, 6):
        got = _split(args, 20, None, n)
        np.testing.assert_allclose(got, pallas, atol=FA_ATOL, rtol=0,
                                   err_msg=f"n_split={n}")
        assert (got[:, :3] == 0).all() and (got[:, 7] == 0).all()
        assert (np.abs(got[:, 3:7]).sum(-1) > 0).all()


@pytest.mark.parametrize("n_split", [1, 3, 50])
def test_split_plain_equals_one_pass_plain(n_split):
    """n_split = 1 is the one-pass algorithm over one chunk; n_split past
    the tile count leaves trailing chunks empty, which weigh nothing."""
    args = _case(4, 3, 1, 130, 2, 4, 64, 129)
    t = [torch.from_numpy(a) for a in args]
    want = fa_ref.flash_attention_ref(*t, 64, 50.0).numpy()
    got = _split(args, 64, 50.0, n_split)
    np.testing.assert_allclose(got, want, atol=FA_ATOL, rtol=0)
    bounds = fa_ref.split_bounds(130, n_split)
    assert len(bounds) == n_split and bounds[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert bounds[-1][1] == 130


@pytest.mark.parametrize("T", [1, 64, 65, 197, 544, 4096, 40000])
@pytest.mark.parametrize("S,G", [(1, 1), (1, 4), (4, 4), (1, 5), (3, 5),
                                 (1, 17), (512, 4)])
def test_split_planner_reads_T_and_rows_only(T, S, G):
    """The planner's split count does not change with B or K, is 0 (the
    prefill path) exactly when S*G exceeds the decode threshold, and gives
    non-empty chunks of whole tiles, at most ``MAX_SPLITS``."""
    plans = {fa_ops.plan_splits((B, S, K, G, 128), T)
             for B in (1, 2, 8, 64) for K in (1, 5, 10, 16)}
    assert len(plans) == 1
    n = plans.pop()
    if S * G > fa_ops.DECODE_ROWS:
        assert n == 0
        return
    tiles = -(-T // fa_ref.KV_TILE)
    assert 1 <= n <= min(tiles, fa_ops.MAX_SPLITS)
    assert all(hi > lo for lo, hi in fa_ref.split_bounds(T, n))


def test_cpu_decode_takes_the_one_pass_plain_version():
    """On the CPU a decode-shaped call is the one-pass plain version, not
    the split-KV one, and counts no launch on any path."""
    args = [torch.from_numpy(a) for a in _case(2, 2, 1, 100, 2, 4, 32, 90)]
    before = (dict(fa_ops.LAUNCHES), dict(fa_ops.PATH_LAUNCHES))
    assert torch.equal(fa_ops.flash_attention(*args),
                       fa_ref.flash_attention_ref(*args))
    assert (dict(fa_ops.LAUNCHES), dict(fa_ops.PATH_LAUNCHES)) == before
