"""The LM training substrate of the port against the JAX reference on the
CPU: the token stream (``data/tokens.py``), the optimizers and schedules
(``optim/optimizers.py``) and the uplink codecs (``dist/__init__.py``), with
the reference's own tests of them (``tests/test_substrate.py``) ported.

Tolerances: token batches exactly; optimizers and schedules rtol 1e-6
(fp32 elementwise arithmetic in the same order); int8 codes exactly and
scales rtol 1e-6; top-k kept sets exactly and residuals exactly; byte
counts exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import dist as jdist  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data.tokens import synthetic_token_batches as j_tokens  # noqa: E402
from repro_torch import dist as tdist  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import synthetic_token_batches as t_tokens  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

RTOL = 1e-6


def _tree(seed, shapes=(("a", (17, 5)), ("b", (8,)))):
    g = np.random.default_rng(seed)
    t = {n: g.normal(size=s).astype(np.float32) for n, s in shapes}
    return {"x": t["a"], "y": {"z": t["b"]}} if len(t) == 2 else t


def _assert_tree(jtree, ttree, rtol=RTOL, atol=0.0, exact=False):
    jl = [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
          jax.tree_util.tree_flatten_with_path(jtree)[0]]
    tl = [(p, x.numpy()) for p, x in leaves_with_path(ttree)]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert a.dtype == b.dtype, p
        if exact:
            np.testing.assert_array_equal(b, a, err_msg=p)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=p)


# ---------------------------------------------------------------------------
# token stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,batch,seq,steps,seed,cb", [
    (64, 4, 32, 3, 0, 0), (128, 8, 128, 2, 3, 0), (5, 2, 7, 4, 1, 0),
    (33, 2, 16, 3, 0, 4), (2048, 3, 9, 2, 5, 2)])
def test_token_batches_equal_reference(vocab, batch, seq, steps, seed, cb):
    jb = list(j_tokens(vocab, batch, seq, steps, seed=seed, n_codebooks=cb))
    tb = list(t_tokens(vocab, batch, seq, steps, seed=seed, n_codebooks=cb))
    assert len(jb) == len(tb) == steps
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(b[k], a[k])


def test_token_stream_learnable():
    """The reference's test_substrate.py test: three batches of [4, 32]."""
    batches = list(t_tokens(64, 4, 32, 3, seed=0))
    assert len(batches) == 3
    assert batches[0]["tokens"].shape == (4, 32)
    np.testing.assert_array_equal(batches[0]["tokens"][:, 1:],
                                  batches[0]["labels"][:, :-1])


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("momentum", [0.9, 0.0, 0.5])
def test_sgd_matches_reference(momentum):
    params = _tree(0)
    jp, js = params, joptim.sgd_init(params)
    tp = params_from_numpy(params, "cpu")
    ts = toptim.sgd_init(tp)
    for step in range(4):
        g = _tree(10 + step)
        jp, js = joptim.sgd_update(jp, g, js, 1e-2, momentum=momentum)
        tp, ts = toptim.sgd_update(tp, params_from_numpy(g, "cpu"), ts, 1e-2,
                                   momentum=momentum)
        _assert_tree(jp, tp)
        _assert_tree(js["mom"], ts["mom"])


@pytest.mark.parametrize("name,kw", [
    ("adam", {}), ("adam", {"weight_decay": 0.1, "b1": 0.8}),
    ("sgd", {}), ("sgd", {"momentum": 0.5})])
def test_make_optimizer_matches_reference(name, kw):
    params = _tree(1)
    jo, to = joptim.make_optimizer(name, **kw), toptim.make_optimizer(name,
                                                                      **kw)
    jp, js = params, jo.init(params)
    tp = params_from_numpy(params, "cpu")
    ts = to.init(tp)
    for step in range(3):
        g = _tree(20 + step)
        jp, js = jo.update(jp, g, js, 3e-3)
        tp, ts = to.update(tp, params_from_numpy(g, "cpu"), ts, 3e-3)
        _assert_tree(jp, tp)
    with pytest.raises(ValueError):
        toptim.make_optimizer("lion")


SCHEDULE_STEPS = [0, 1, 5, 9, 10, 11, 37, 99, 109, 110, 111, 500]


@pytest.mark.parametrize("tensor_step", [False, True])
def test_schedules_match_reference(tensor_step):
    """Both schedules at every phase (warmup, its end, decay, past the
    end), for an int step and a 0-d int32 tensor step."""
    pairs = [(joptim.cosine_schedule(0.3, 100),
              toptim.cosine_schedule(0.3, 100)),
             (joptim.cosine_schedule(1e-3, 0, min_frac=0.2),
              toptim.cosine_schedule(1e-3, 0, min_frac=0.2)),
             (joptim.linear_warmup_cosine(1.0, 10, 110),
              toptim.linear_warmup_cosine(1.0, 10, 110)),
             (joptim.linear_warmup_cosine(3e-4, 0, 50),
              toptim.linear_warmup_cosine(3e-4, 0, 50))]
    for jfn, tfn in pairs:
        for s in SCHEDULE_STEPS:
            got = tfn(torch.tensor(s, dtype=torch.int32) if tensor_step
                      else s)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), float(jfn(s)), rtol=RTOL,
                                       atol=1e-12)


def test_a_schedule_value_reaches_the_step_unchanged():
    """Adam and SGD with lr = the schedule's 0-d tensor, against the
    reference with its jnp value, over a warmup-cosine run."""
    jfn = joptim.linear_warmup_cosine(1e-2, 3, 8)
    tfn = toptim.linear_warmup_cosine(1e-2, 3, 8)
    params = _tree(2)
    for init_upd in (("adam_init", "adam_update"), ("sgd_init",
                                                     "sgd_update")):
        jinit, jupd = (getattr(joptim, n) for n in init_upd)
        tinit, tupd = (getattr(toptim, n) for n in init_upd)
        jp, js = params, jinit(params)
        tp = params_from_numpy(params, "cpu")
        ts = tinit(tp)
        for step in range(8):
            g = _tree(30 + step)
            jp, js = jupd(jp, g, js, jfn(step))
            tp, ts = tupd(tp, params_from_numpy(g, "cpu"), ts, tfn(step))
            _assert_tree(jp, tp)


def test_adam_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = toptim.adam_init(params)
    for _ in range(500):
        grads = {"w": 2 * (params["w"] - target)}
        params, state = toptim.adam_update(params, grads, state, 0.05)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_adam_moments_fp32_for_bf16_params():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = toptim.adam_init(params)
    assert state["m"]["w"].dtype == torch.float32
    new_p, new_s = toptim.adam_update(
        params, {"w": torch.ones(4, dtype=torch.bfloat16)}, state, 1e-2)
    assert new_p["w"].dtype == torch.bfloat16
    assert new_s["v"]["w"].dtype == torch.float32


def test_schedules():
    fn = toptim.linear_warmup_cosine(1.0, warmup=10, total_steps=110)
    assert float(fn(0)) == 0.0
    np.testing.assert_allclose(float(fn(10)), 1.0, rtol=1e-5)
    assert float(fn(110)) < 0.1


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_matches_reference(seed):
    g = np.random.default_rng(seed)
    tree = {"a": g.normal(size=(33, 7)).astype(np.float32) * 3,
            "b": {"c": g.normal(size=(64,)).astype(np.float32)},
            "z": np.zeros((4, 4), np.float32)}
    jq, js = jdist.quantize_int8(tree)
    tq, ts = tdist.quantize_int8(params_from_numpy(tree, "cpu"))
    _assert_tree(jq, tq, exact=True)
    _assert_tree(js, ts)
    _assert_tree(jdist.dequantize_int8(jq, js),
                 tdist.dequantize_int8(tq, ts), atol=1e-7)


TIE_CASES = [  # flat values, frac: ties at the threshold keep them all
    ([1.0, -2.0, 2.0, 0.5, -2.0, 0.1], 0.34),  # k=3 of a 3-way tie at 2
    ([1.0, 1.0, 1.0, 1.0], 0.25),  # k=1, all tied: all kept
    ([0.0, 0.0, 0.3, -0.3, 0.2], 0.2),  # k=1 at a 2-way tie
    ([3.0, -1.0, 2.0, -2.0, 1.0, 0.0, 0.0, 2.0], 0.5),  # k=4 at +-2, 1
]


@pytest.mark.parametrize("values,frac", TIE_CASES)
def test_topk_ties_keep_the_reference_set(values, frac):
    x = {"w": np.asarray(values, np.float32)}
    js, je = jdist.topk_sparsify(x, frac)
    ts, te = tdist.topk_sparsify(params_from_numpy(x, "cpu"), frac)
    np.testing.assert_array_equal(ts["w"].numpy() != 0,
                                  np.asarray(js["w"]) != 0)
    _assert_tree(js, ts, exact=True)
    _assert_tree(je, te, exact=True)


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.37, 1.0])
def test_topk_matches_reference_with_error_feedback(frac):
    """Three rounds, the residual carried: sparse uploads (so the kept
    sets) and residuals exactly equal. The values are drawn on a coarse grid
    so that ties occur."""
    g = np.random.default_rng(7)
    jerr = terr = None
    for r in range(3):
        x = {"a": np.round(g.normal(size=(40, 6)) * 4).astype(np.float32)
             / 4, "b": g.normal(size=(9,)).astype(np.float32)}
        js, jerr = jdist.topk_sparsify(x, frac, jerr)
        ts, terr = tdist.topk_sparsify(params_from_numpy(x, "cpu"), frac,
                                       terr)
        _assert_tree(js, ts, exact=True)
        _assert_tree(jerr, terr, exact=True)


@pytest.mark.parametrize("mode,frac", [("none", None), ("int8", None),
                                       ("topk", 0.1), ("topk", 0.003)])
def test_compressed_size_matches_reference(mode, frac):
    tree = _tree(3, (("a", (17, 5)), ("b", (8,)), ("c", (2, 3, 4))))
    assert tdist.compressed_size_bytes(params_from_numpy(tree, "cpu"), mode,
                                       frac) == \
        jdist.compressed_size_bytes(tree, mode, frac)


def test_compressed_size_rejects_what_it_does_not_know():
    tree = {"w": torch.zeros(10)}
    with pytest.raises(ValueError):
        tdist.compressed_size_bytes(tree, "fp16")
    with pytest.raises(ValueError):
        tdist.compressed_size_bytes(tree, "topk")


# the reference's compression tests (tests/test_substrate.py), ported


@settings(deadline=None, max_examples=20)
@given(st.integers(0, 10**6))
def test_int8_quantization_error_bound(seed):
    rng = np.random.default_rng(seed)
    tree = {"w": torch.as_tensor(rng.normal(size=(32, 8)), dtype=torch.float32)}
    qt, sc = tdist.quantize_int8(tree)
    assert qt["w"].dtype == torch.int8
    back = tdist.dequantize_int8(qt, sc)
    max_err = float((back["w"] - tree["w"]).abs().max())
    assert max_err <= float(sc["w"]) * 0.5 + 1e-7  # half-step rounding


def test_topk_error_feedback_accumulates():
    x = {"w": torch.tensor([1.0, 0.1, 0.01, -2.0])}
    sparse, err = tdist.topk_sparsify(x, frac=0.25)  # keep 1 of 4
    assert int((sparse["w"] != 0).sum()) == 1
    assert float(sparse["w"][3]) == -2.0
    # error feedback: dropped mass resurfaces next round
    sparse2, _ = tdist.topk_sparsify({"w": torch.zeros(4)}, frac=0.25,
                                     error=err)
    assert float(sparse2["w"][0]) == 1.0


def test_compressed_size_accounting():
    tree = {"w": torch.zeros(100)}
    assert tdist.compressed_size_bytes(tree, "none") == 400
    assert tdist.compressed_size_bytes(tree, "int8") == 104
    assert tdist.compressed_size_bytes(tree, "topk", 0.1) == 80


def test_compressed_size_matches_actual_payload_bytes():
    """The accounting equals the bytes a real int8 payload occupies: the
    codes per leaf + one fp32 scale per leaf."""
    rng = np.random.default_rng(3)
    tree = {"a": torch.as_tensor(rng.normal(size=(17, 5)), dtype=torch.float32),
            "b": {"c": torch.as_tensor(rng.normal(size=(8,)),
                                       dtype=torch.float32)}}
    qt, sc = tdist.quantize_int8(tree)
    actual = sum(q.numel() * q.element_size() for q in leaves(qt)) + \
        sum(s.numel() * s.element_size() for s in leaves(sc))
    assert tdist.compressed_size_bytes(tree, "int8") == actual
    assert tdist.compressed_size_bytes(tree, "none") == \
        sum(x.numel() * x.element_size() for x in leaves(tree))


@settings(deadline=None, max_examples=10)
@given(st.integers(0, 10**6))
def test_int8_error_feedback_telescopes(seed):
    """Over T rounds, sum(dequantized uploads) + final residual ==
    sum(raw updates)."""
    rng = np.random.default_rng(seed)
    updates = [{"w": torch.as_tensor(rng.normal(size=(16, 4)),
                                     dtype=torch.float32)} for _ in range(6)]
    err = None
    shipped = torch.zeros(16, 4)
    for u in updates:
        qt, sc, err = tdist.quantize_int8_ef(u, err)
        shipped = shipped + tdist.dequantize_int8(qt, sc)["w"]
    total = sum(u["w"] for u in updates)
    np.testing.assert_allclose((shipped + err["w"]).numpy(), total.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert float(err["w"].abs().max()) <= float(sc["w"]) * 0.5 + 1e-7


@settings(deadline=None, max_examples=10)
@given(st.integers(0, 10**6))
def test_int8_stacked_matches_per_client(seed):
    """Stacked per-client quantization == quantizing each client's slice
    separately."""
    rng = np.random.default_rng(seed)
    K = 4
    stack = {"w": torch.as_tensor(rng.normal(size=(K, 6, 3)),
                                  dtype=torch.float32)}
    qt, sc, resid = tdist.quantize_int8_stacked(stack)
    assert qt["w"].dtype == torch.int8 and sc["w"].shape == (K,)
    for k in range(K):
        qk, sk = tdist.quantize_int8({"w": stack["w"][k]})
        np.testing.assert_array_equal(qt["w"][k].numpy(), qk["w"].numpy())
        np.testing.assert_allclose(float(sc["w"][k]), float(sk["w"]),
                                   rtol=1e-6)
    back = tdist.dequantize_int8_stacked(qt, sc)
    np.testing.assert_allclose(resid["w"].numpy(),
                               (stack["w"] - back["w"]).numpy(), atol=1e-7)


def test_topk_error_feedback_telescopes_over_rounds():
    rng = np.random.default_rng(0)
    updates = [{"w": torch.as_tensor(rng.normal(size=(32,)),
                                     dtype=torch.float32)} for _ in range(8)]
    err = None
    shipped = torch.zeros(32)
    for u in updates:
        sparse, err = tdist.topk_sparsify(u, frac=0.25, error=err)
        shipped = shipped + sparse["w"]
    total = sum(u["w"] for u in updates)
    np.testing.assert_allclose((shipped + err["w"]).numpy(), total.numpy(),
                               rtol=1e-4, atol=1e-5)

