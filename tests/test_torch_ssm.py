"""The port's recurrent families against the JAX reference, on the CPU: the
plain SSD scan (vs the Pallas kernel in interpret mode and the XLA path),
mamba2-1.3b and hymba-1.5b SMOKE in fp32 (forward, prefill into caches,
decode), the hymba continuous-batching engine and the serve entry point.
Inputs come from seeded numpy generators; parameters are drawn by the
reference and carried over through ``params_from_numpy``.

The reference's model-level forward runs its SSD kernel only without
``interpret`` (off the CPU), so the models are held against its ``"xla"``
path, the chunked form that is also its kernel's oracle; the port runs
both its plain path and its kernel op (the plain version on a CPU tensor).

Tolerances: the SSD scan 1e-4, as the reference's kernel tests; model
logits and caches 1e-4 (fp32 sums in another order over a few layers);
engine tokens exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.kernels.ssd.ops import ssd as j_ssd  # noqa: E402
from repro.launch import serving_engine as JSE  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import ssm as JSM  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import serving_engine as TSE  # noqa: E402
from repro_torch.launch import step_fns as tstep  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import ssm as TSM  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

SSD_ATOL, MODEL_ATOL = 1e-4, 1e-4
ARCHS = ["mamba2-1.3b", "hymba-1.5b"]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process, so torch's CPU ops run 2
    threads: with all 8 they contend with it and run ~4x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# SSD scan: plain version vs Pallas (interpret), the XLA path, the recurrence
# ---------------------------------------------------------------------------


def _ssd_case(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(f)  # softplus
    A_log = rng.normal(size=h).astype(f)
    Bm = rng.normal(size=(b, s, n)).astype(f)
    Cm = rng.normal(size=(b, s, n)).astype(f)
    return x, dt, A_log, Bm, Cm


@pytest.mark.parametrize("s,h,p,n,chunk,bh", [
    (64, 4, 16, 8, 16, 2), (128, 8, 8, 16, 32, 8), (32, 2, 32, 4, 32, 1),
])
def test_ssd_plain_matches_pallas_and_xla(s, h, p, n, chunk, bh):
    args = _ssd_case(2, s, h, p, n, s + h + p + n)
    before = dict(ssd_ops.LAUNCHES)
    y, fs = ssd_ops.ssd(*map(_t, args), chunk)
    assert ssd_ops.LAUNCHES == before  # a CPU tensor never reaches a kernel
    jargs = list(map(jnp.asarray, args))
    yp, fp = j_ssd(*jargs, chunk=chunk, impl="pallas", interpret=True, bh=bh)
    yx, fx = j_ssd(*jargs, chunk=chunk, impl="xla")
    for want_y, want_f in ((yp, fp), (yx, fx)):
        np.testing.assert_allclose(y.numpy(), _np(want_y), atol=SSD_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(fs.numpy(), _np(want_f), atol=SSD_ATOL,
                                   rtol=0)


def test_ssd_plain_with_initial_state_matches_xla():
    """Only the plain version takes a carried state (the kernel starts at
    zero, as the reference's kernel does)."""
    x, dt, A_log, Bm, Cm = _ssd_case(2, 64, 4, 16, 8, 3)
    s0 = np.random.default_rng(4).normal(size=(2, 4, 16, 8)).astype(
        np.float32)
    y, fs = ssd_ops.ssd(*map(_t, (x, dt, A_log, Bm, Cm)), 16,
                        initial_state=_t(s0))
    yx, fx = j_ssd(*map(jnp.asarray, (x, dt, A_log, Bm, Cm)), chunk=16,
                   initial_state=jnp.asarray(s0), impl="xla")
    np.testing.assert_allclose(y.numpy(), _np(yx), atol=SSD_ATOL, rtol=0)
    np.testing.assert_allclose(fs.numpy(), _np(fx), atol=SSD_ATOL, rtol=0)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_ref.ssd_ref(*map(_t, (x, dt, A_log, Bm, Cm)), 24)


def test_ssd_decode_steps_match_the_chunked_scan_and_the_reference():
    """Token by token, the port's O(1) update reproduces the chunked scan
    (y and the final state) and the reference's decode step."""
    x, dt, A_log, Bm, Cm = _ssd_case(1, 32, 2, 8, 4, 5)
    y, fs = ssd_ref.ssd_ref(*map(_t, (x, dt, A_log, Bm, Cm)), 8)
    state = torch.zeros((1, 2, 8, 4))
    jstate = jnp.zeros((1, 2, 8, 4))
    for t in range(32):
        yt, state = TSM.ssd_decode_step(state, _t(x[:, t]), _t(dt[:, t]),
                                        _t(A_log), _t(Bm[:, t]),
                                        _t(Cm[:, t]))
        jy, jstate = JSM.ssd_decode_step(jstate, x[:, t], dt[:, t], A_log,
                                         Bm[:, t], Cm[:, t])
        np.testing.assert_allclose(yt.numpy(), y[:, t].numpy(),
                                   atol=SSD_ATOL, rtol=0)
        np.testing.assert_allclose(yt.numpy(), _np(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(state.numpy(), fs.numpy(), atol=SSD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(state.numpy(), _np(jstate), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# models: mamba2 and hymba SMOKE, reference weights carried over
# ---------------------------------------------------------------------------


def _configs(arch, **kw):
    jcfg = dataclasses.replace(jbase.get_arch(arch).SMOKE, **kw)
    tcfg = dataclasses.replace(tbase.get_arch(arch).SMOKE, **kw)
    return jcfg, tcfg


def _perturbed_lora(lora, seed):
    """Init's b = 0 makes LoRA a no-op; perturb so it is exercised."""
    return jax.tree.map(lambda x: x + 0.05 * jax.random.normal(
        jax.random.PRNGKey(seed), x.shape, x.dtype), lora)


def _jparams(jcfg):
    p = japi.init_model(jax.random.PRNGKey(0), jcfg)
    p["lora"] = _perturbed_lora(p["lora"], 1)
    return p


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _assert_tree_close(jtree, ttree, atol):
    jl = [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
          jax.tree_util.tree_flatten_with_path(jtree)[0]]
    tl = [(p, x.numpy()) for p, x in leaves_with_path(ttree)]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert a.dtype == b.dtype, p
        np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=p)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_lora_shapes_match_the_reference(arch):
    """Same leaf paths, shapes and dtypes as the reference's init (SMOKE),
    and the registry's LoRA shapes at FULL (hymba's fusion wo takes the
    4800-wide [attention ; SSD] input)."""
    jcfg, tcfg = _configs(arch)
    jp = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0), jcfg))
    tp = tapi.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    jl = [(jax.tree_util.keystr(p), x.shape, str(x.dtype)) for p, x in
          jax.tree_util.tree_flatten_with_path(jp)[0]]
    tl = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
          for p, x in leaves_with_path(tp)]
    assert jl == tl
    full = tbase.get_arch(arch).FULL
    jfull = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0),
                                                   jbase.get_arch(arch).FULL))
    want = {k: (v["a"].shape[1], v["b"].shape[2])
            for k, v in jfull["lora"]["layers"].items()}
    assert tapi.lora_shapes(full) == want
    if arch == "hymba-1.5b":
        assert want["wo"] == (4800, 1600)
        assert tapi.fusion_block_dims(full) == japi.fusion_block_dims(
            jbase.get_arch(arch).FULL) == (1600, 3200)
    else:
        with pytest.raises(ValueError, match="no fusion projection"):
            tapi.fusion_block_dims(full)


@functools.lru_cache(maxsize=None)
def _jit(fn, cfg):
    return jax.jit(functools.partial(fn, cfg=cfg))


def _j_prefill(params, caches, tokens, cfg):
    return japi.prefill_with_cache(params, cfg, caches, tokens)


def _j_decode(params, caches, token, pos, cfg):
    return japi.decode_step(params, cfg, caches, token, pos)


def _j_forward(params, tokens, cfg):
    return japi.forward(params, cfg, {"tokens": tokens})[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_the_reference(arch):
    """Forward logits; the last logits and every cache leaf after
    ``prefill_with_cache``; 8 decode steps after it; and the prefill step --
    the reference's XLA path vs the port's plain ("xla") and kernel-op
    ("pallas") paths. 24 tokens pass hymba's window of 16."""
    jcfg, tcfg = _configs(arch)
    jp = _jparams(jcfg)
    tp = _port(jp)
    B, S, max_len, n_dec = 2, 12, 24, 8
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (B, 32)
                                               ).astype(np.int32)
    jlogits = _jit(_j_forward, jcfg)(jp, jnp.asarray(tokens))
    jc = japi.init_caches(jcfg, B, max_len)
    jlast, jc = _jit(_j_prefill, jcfg)(jp, jc, jnp.asarray(tokens[:, :S]))
    jc_prefill = jc
    jsteps, jcs = [], []
    for t in range(S, S + n_dec):
        lg, jc = _jit(_j_decode, jcfg)(jp, jc, jnp.asarray(tokens[:, t:t + 1]),
                                        jnp.int32(t))
        jsteps.append(lg)
        jcs.append(jc)
    tt = torch.from_numpy(tokens)
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        logits, _ = tapi.forward(tp, cfg, {"tokens": tt})
        np.testing.assert_allclose(logits.numpy(), _np(jlogits),
                                   atol=MODEL_ATOL, rtol=0)
        tc = tapi.init_caches(cfg, B, max_len, device="cpu")
        last, tc = tapi.prefill_with_cache(tp, cfg, tc, tt[:, :S])
        np.testing.assert_allclose(last.numpy(), _np(jlast), atol=MODEL_ATOL,
                                   rtol=0)
        _assert_tree_close(jc_prefill, tc, MODEL_ATOL)
        for t, want, want_c in zip(range(S, S + n_dec), jsteps, jcs):
            step, tc = tapi.decode_step(tp, cfg, tc, tt[:, t:t + 1], t)
            np.testing.assert_allclose(step.numpy(), _np(want),
                                       atol=MODEL_ATOL, rtol=0)
            _assert_tree_close(want_c, tc, MODEL_ATOL)
        prefill = tstep.make_prefill_step(cfg)(tp, {"tokens": tt})
        np.testing.assert_allclose(prefill.numpy(), _np(jlogits[:, -1]),
                                   atol=MODEL_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_matches_forward(arch, impl):
    """Token-by-token decode reproduces the full-sequence forward (the
    chunked scan), as the reference's ``test_decode_matches_forward``; 32
    tokens wrap hymba's 16-slot ring twice."""
    _, tcfg = _configs(arch, attn_impl=impl)
    tp = tapi.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    B, S = 2, 32
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab, (B, S)).astype(np.int32))
    full, _ = tapi.forward(tp, tcfg, {"tokens": tok})
    caches = tapi.init_caches(tcfg, B, S, device="cpu")
    steps = []
    for t in range(S):
        lg, caches = tapi.decode_step(tp, tcfg, caches, tok[:, t:t + 1], t)
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1), full, atol=MODEL_ATOL,
                               rtol=0)


def test_ssm_rejects_adapters_and_fusion_masks():
    _, tcfg = _configs("mamba2-1.3b")
    tp = tapi.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    caches = tapi.init_caches(tcfg, 1, 8, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="no fusion projection"):
        tapi.decode_step(tp, tcfg, caches, tok, 0,
                         adapter_idx=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="no fusion projection"):
        TSE.AdapterRegistry(tcfg, capacity=2, device="cpu")


# ---------------------------------------------------------------------------
# hymba engine: port vs reference tokens, join/leave, two fusion blocks
# ---------------------------------------------------------------------------

# per client: both blocks, the SSD block absent, the attention block absent
MASKS = [np.array(m, np.float32) for m in ([1, 1], [1, 0], [0, 1])]


def _registries(jcfg, tcfg):
    jreg = JSE.AdapterRegistry(jax.random.PRNGKey(1), jcfg,
                               capacity=len(MASKS))
    treg = TSE.AdapterRegistry(tcfg, capacity=len(MASKS), device="cpu")
    assert treg.block_dims == jreg.block_dims == (80, 64)
    for i, mm in enumerate(MASKS):
        lora = _perturbed_lora(
            japi.init_model(jax.random.PRNGKey(50 + i), jcfg)["lora"], 99 + i)
        jreg.register(f"c{i}", lora, modality_mask=mm)
        treg.register(f"c{i}", _port(lora), modality_mask=mm)
    np.testing.assert_array_equal(treg.fusion_masks.numpy(),
                                  _np(jreg.fusion_masks))
    return jreg, treg


def _requests(cls, prompts, new_tokens):
    return [cls(rid=f"r{i}", prompt=p, adapter=f"c{i % len(MASKS)}",
                max_new_tokens=int(n))
            for i, (p, n) in enumerate(zip(prompts, new_tokens))]


def _serve(cls_engine, params, cfg, reg, reqs, slots, max_len, **kw):
    eng = cls_engine(params, cfg, reg, batch_slots=slots, max_len=max_len,
                     **kw)
    for r in reqs:
        eng.submit(r)
    return eng, eng.run()["outputs"]


def test_hymba_engine_matches_reference_engine_and_naive():
    """2 slots, 5 requests with ragged prompts (some past the 16-slot ring)
    and lengths: rows finish and new ones join mid-stream through recycled
    slots, whose conv and SSM states the admission overwrites. The port's
    tokens (kernel op and plain version) equal the reference engine's and
    the per-request baseline's; the masks differ per client, so each
    fusion block is absent for some row."""
    jcfg, tcfg = _configs("hymba-1.5b")
    jp = _jparams(jcfg)
    tp = _port(jp)
    jreg, treg = _registries(jcfg, tcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, n) for n in (4, 18, 5, 7, 3)]
    new = [6, 3, 8, 4, 7]
    _, want = _serve(JSE.ServingEngine, jp, jcfg, jreg,
                     _requests(JSE.Request, prompts, new), 2, 28)
    for impl in ("pallas", "xla"):
        reqs = _requests(TSE.Request, prompts, new)
        eng, got = _serve(TSE.ServingEngine, tp, tcfg, treg, reqs, 2, 28,
                          lora_impl=impl)
        assert got == want
    assert [len(got[r.rid]) for r in reqs] == new
    assert TSE.naive_serve(tp, tcfg, treg, reqs, 28)["outputs"] == want
    fresh = eng._fresh_row
    assert (fresh["attn"]["pos"] == -1).all()
    assert not fresh["ssm"]["state"].any() and not fresh["ssm"]["conv"].any()


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,engine", [("mamba2-1.3b", False),
                                         ("hymba-1.5b", False),
                                         ("hymba-1.5b", True)],
                         ids=["mamba2", "hymba", "hymba_engine"])
def test_serve_entry_point_on_cpu(arch, engine, capsys):
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--decode-steps", "4"]
    res = tserve.main(args + (["--engine"] if engine else []))
    if engine:
        assert res["generated_tokens"] == 4 * 4  # 2 x batch requests
        assert all(len(v) == 4 for v in res["outputs"].values())
    else:
        assert res["tokens"].shape == (2, 4)
        assert torch.isfinite(res["prefill_logits"]).all()
    assert f"[serve{'/engine' if engine else ''}] {arch}" in \
        capsys.readouterr().out
