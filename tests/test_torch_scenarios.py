"""The port's scenario matrix (``sim/scenarios.py``), streaming modality
schedules and FedMFS selective upload against the JAX reference, on the
CPU: the missing-modality generators, fleets and schedules exactly equal,
the ``from_scenario`` configs field by field, the selective uploader's
choice (ties included), ``make_run`` runs on PAMAP2_B2_SMALL against the
reference's, the port's heap and vectorized runtimes under a streaming
schedule, and system-only runs under churn.

Both packages get the same numpy inputs and the reference's initial
weights; the port runs the plain versions of its kernels here (CPU
tensors). The reference runs share one compiled local update."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import async_engine as JA  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.sim import FleetConfig as JFleetConfig  # noqa: E402
from repro.sim import scenarios as JSC  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import async_engine as TA  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.sim import FleetConfig as TFleetConfig  # noqa: E402
from repro_torch.sim import scenarios as TSC  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

# PAMAP2_B2_SMALL (the transformer backbone at small width), short local
# training: every run of the file shares one model shape
B2 = dict(backbone="transformer", small_model=True, windows_per_subject=40,
          local_epochs=1, steps_per_epoch=2, batch_size=8, eval_every=0)
FLEET_FIELDS = ("modality_mask", "tops", "active_power", "comm_power",
                "idle_power", "bandwidth_mbps")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process, so torch's CPU ops run 2
    threads: with all 8 they contend with it and run ~4x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_fleets_equal(jf, tf):
    for f in FLEET_FIELDS:
        np.testing.assert_array_equal(getattr(tf, f), getattr(jf, f),
                                      err_msg=f)
    assert list(tf.type_names) == list(jf.type_names)


def _assert_schedules_equal(js, ts):
    for f in ("period", "phase", "anchor", "base"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                      err_msg=f)
    assert ts.duty == js.duty and (ts.N, ts.M) == (js.N, js.M)


# ---------------------------------------------------------------------------
# missing-modality generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("N,M,seed", [(8, 4, 0), (10, 4, 3), (37, 2, 11)])
def test_static_mask_equals_reference(ratio, N, M, seed):
    base = np.ones((N, M), bool)
    if M == 4:
        base[-2:, 2:] = False  # a partial base: the walk skips absent pairs
    try:
        want = JSC.static_missing_mask(base, ratio, seed)
    except ValueError:
        with pytest.raises(ValueError, match="cannot drop"):
            TSC.static_missing_mask(base, ratio, seed)
        return
    got = TSC.static_missing_mask(base, ratio, seed)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) >= 1).all()


def test_static_mask_infeasible_raises_as_reference():
    base = np.ones((4, 2), bool)  # at most 4 of 8 pairs can go
    for mod in (JSC, TSC):
        with pytest.raises(ValueError, match="cannot drop"):
            mod.static_missing_mask(base, 0.75, 0)


@pytest.mark.parametrize("ratio", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("fleet,seed", [((3, 3, 2), 0), ((4, 3, 5), 7)])
def test_tiered_mask_equals_reference(ratio, fleet, seed):
    jf = JSC.build_fleet(JSC.ScenarioSpec("t", missing="static",
                                          missing_ratio=0.0, fleet=fleet))
    tf = TSC.build_fleet(TSC.ScenarioSpec("t", missing="static",
                                          missing_ratio=0.0, fleet=fleet))
    np.testing.assert_array_equal(TSC.device_tiers(tf), JSC.device_tiers(jf))
    got = TSC.tiered_missing_mask(tf.modality_mask, TSC.device_tiers(tf),
                                  ratio, seed)
    np.testing.assert_array_equal(
        got, JSC.tiered_missing_mask(jf.modality_mask, JSC.device_tiers(jf),
                                     ratio, seed))


@pytest.mark.parametrize("ratio,period,seed", [(0.3, 40.0, 0), (0.1, 5.0, 3),
                                               (0.5, 123.4, 9)])
def test_streaming_schedule_equals_reference(ratio, period, seed):
    """Periods, phases, anchors and base bit for bit, and the live masks at
    several times (whole fleet and client subsets), anchors always on."""
    base = np.ones((12, 4), bool)
    base[3, 1:] = False
    base[7, :2] = False
    js = JSC.streaming_schedule(base, ratio, period, seed)
    ts = TSC.streaming_schedule(base, ratio, period, seed)
    _assert_schedules_equal(js, ts)
    idx = np.array([7, 0, 3, 11, 3])
    for t in (0.0, 0.05, 1.7, 19.999, period, 1e3 + 0.1, 12345.678):
        np.testing.assert_array_equal(ts.masks_at(t), js.masks_at(t))
        got = ts.masks_at(t, idx)
        np.testing.assert_array_equal(got, js.masks_at(t, idx))
        assert got[np.arange(len(idx)), ts.anchor[idx]].all()


# ---------------------------------------------------------------------------
# fleets, schedules and configs from a spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", JSC.scenario_names())
def test_library_fleets_equal_reference(name):
    assert TSC.scenario_names() == JSC.scenario_names()
    js, ts = JSC.get_scenario(name), TSC.get_scenario(name)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    _assert_fleets_equal(JSC.build_fleet(js), TSC.build_fleet(ts))
    _assert_fleets_equal(JFleetConfig.from_scenario(js),
                         TFleetConfig.from_scenario(ts))
    jsch, tsch = JSC.schedule_for(js), TSC.schedule_for(ts)
    assert (jsch is None) == (tsch is None) == (js.missing != "streaming")
    if jsch is not None:
        _assert_schedules_equal(jsch, tsch)


@pytest.mark.parametrize("name,kw", [
    ("static30", dict(n_clients=50)), ("tiered30", dict(n_clients=33,
                                                         seed=5)),
    ("stream30", dict(n_clients=20, hetero_scale=100.0)),
    ("paper", dict(hetero_scale=10.0, seed=2))])
def test_scaled_fleets_equal_reference(name, kw):
    js, ts = JSC.get_scenario(name, **kw), TSC.get_scenario(name, **kw)
    jf, tf = JSC.build_fleet(js), TSC.build_fleet(ts)
    _assert_fleets_equal(jf, tf)
    if js.missing == "streaming":
        _assert_schedules_equal(JSC.schedule_for(js, jf),
                                TSC.schedule_for(ts, tf))


def test_unknown_scenario_and_bad_specs_raise():
    with pytest.raises(KeyError, match="unknown scenario"):
        TSC.get_scenario("static20")
    with pytest.raises(ValueError, match="missing must be"):
        TSC.ScenarioSpec("x", missing="bursty")
    with pytest.raises(ValueError, match="missing_ratio"):
        TSC.ScenarioSpec("x", missing_ratio=1.0)


@pytest.mark.parametrize("name", ["static30", "stream30", "paper"])
def test_from_scenario_configs_equal_reference(name):
    kw = dict(rounds=3, lr=2e-3, uplink_codec="int8", jitter_sigma=0.2,
              total_updates=17, grad_mode="cohort")
    js, ts = JSC.get_scenario(name, **kw), TSC.get_scenario(name, **kw)
    assert TE.scenario_fed_kwargs(ts) == JE.scenario_fed_kwargs(js)
    jfed = JE.FedConfig.from_scenario(js, t_overhead=0.5)
    tfed = TE.FedConfig.from_scenario(ts, t_overhead=0.5)
    assert dataclasses.asdict(tfed) == dataclasses.asdict(jfed)
    jaf = JA.AsyncFedConfig.from_scenario(js, fleet=JSC.build_fleet(js))
    taf = TA.AsyncFedConfig.from_scenario(ts, fleet=TSC.build_fleet(ts))
    for f in dataclasses.fields(TA.AsyncFedConfig):
        if f.name == "modality_schedule":
            continue
        assert getattr(taf, f.name) == getattr(jaf, f.name), f.name
    assert (taf.modality_schedule is None) == (jaf.modality_schedule is None)
    if jaf.modality_schedule is not None:
        _assert_schedules_equal(jaf.modality_schedule, taf.modality_schedule)
    # an explicit override wins over the derived schedule
    assert TA.AsyncFedConfig.from_scenario(
        ts, modality_schedule=None).modality_schedule is None
    sc = TSC.build_scenario(ts)
    assert sc.schedule is sc.fed.modality_schedule
    assert sc.strategy == TS.get(ts.strategy)


# ---------------------------------------------------------------------------
# FedMFS selective upload
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def b2_task():
    from repro.core.tasks import MMTask as JTask
    from repro.data import get_provider as j_provider
    from repro_torch.core.tasks import MMTask as TTask
    from repro_torch.data import get_provider as t_provider

    jtask, jtr0 = JTask.create(j_provider("pamap2").mm_config(
        "transformer", small=True), jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtask.params(jtr0))
    ttask, ttr0 = TTask.create(t_provider("pamap2").mm_config(
        "transformer", small=True), params=params, device="cpu")
    return jtask, jtr0, ttask, ttr0, params, {}


def _seeded_deltas(jtr0, K, seed, ties):
    """[K, ...] deltas; with ``ties`` two fusion blocks and two encoder
    layers of equal size carry equal values (exact ties in utility per
    byte), one client's mag rows are zero, and another's head is zero."""
    g = np.random.default_rng(seed)
    d = jax.tree.map(
        lambda x: (0.01 * g.normal(size=(K,) + np.shape(x))
                   ).astype(np.float32), jax.tree.map(np.asarray, jtr0))
    if ties:
        a = d["lora"]["fusion"]["a"]  # [K, D, r], blocks of 16 rows
        a[:, 16:32] = a[:, 0:16]
        a[0, 32:48] = 0.0
        enc = d["lora"]["encoders"]
        for (_, x), (_, y) in zip(
                jax.tree_util.tree_flatten_with_path(enc["acc"])[0],
                jax.tree_util.tree_flatten_with_path(enc["gyro"])[0]):
            y[:, 1] = x[:, 1]
        for leaf in jax.tree_util.tree_leaves(d["head"]):
            leaf[1] = 0.0
    return d


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("budget", [0.2, 0.5, 1.0])
def test_selective_upload_equals_reference(b2_task, ties, budget):
    """S_up from seeded deltas and trained sets (one client trains nothing)
    equal to the reference's, and the gated rows exactly equal."""
    jtask, jtr0, ttask = b2_task[:3]
    K, G = 6, jtask.layout.G
    d = _seeded_deltas(jtr0, K, 3 + int(ties), ties)
    S = np.random.default_rng(9).random((K, G)) > 0.3
    S[2] = False
    S &= jtask.layout.sizes[None, :] > 0
    want = JA._selective_upload(jtask.layout, d, S, budget)
    td = params_from_numpy(d, "cpu")
    got = TA._selective_upload(ttask.layout, td, S, budget)
    np.testing.assert_array_equal(got, want)
    assert not got[2].any() and (got <= S).all()
    assert (got.sum(1)[S.any(1)] >= 1).all()
    jg = JA._gate_rows(jtask.layout, jax.tree.map(np.asarray, d), want)
    tg = TA._gate_rows(ttask.layout, td, got)
    jl = jax.tree_util.tree_flatten_with_path(jg)[0]
    tl = leaves_with_path(params_to_numpy(tg))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(b, np.asarray(a),
                                      err_msg=jax.tree_util.keystr(p))


# ---------------------------------------------------------------------------
# runs built by make_run
# ---------------------------------------------------------------------------


def _make_pair(b2_task, name, strategy, **kw):
    """The reference's and the port's ``make_run`` from one spec, the port
    with the reference's weights; the reference runs share one compiled
    local update (per proximal term) through the fixture's dict."""
    params, shared = b2_task[4:]
    js = JSC.get_scenario(name, strategy=strategy, **(B2 | kw))
    ts = TSC.get_scenario(name, strategy=strategy, **(B2 | kw))
    jrun, jsc = JSC.make_run(js)
    jrun.local_update = shared.setdefault(jrun.strategy.prox_mu,
                                          jrun.local_update)
    trun, tsc = TSC.make_run(ts, params=params, device="cpu")
    return (jrun, jsc), (trun, tsc)


def _assert_histories(jh, th, flushes):
    assert len(jh["flush"]) == len(th["flush"]) == flushes
    for key in ("flush", "sim_time_s", "staleness_mean", "selected_frac",
                "energy_j"):
        assert th[key] == jh[key], key
    np.testing.assert_allclose(th["upload_mb"], jh["upload_mb"], rtol=1e-9)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)


def _assert_trainable_close(jtree, ttree, atol):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = leaves_with_path(params_to_numpy(ttree))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), atol=atol, rtol=0.0,
                                   err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("name,strategy,codec", [
    ("static30", "relief_selective", "none"),
    ("static30", "relief_selective", "int8"),
    ("stream30", "async_relief", "none"),
    ("stream30", "fedmfs_selective", "none")])
def test_make_run_matches_reference(b2_task, monkeypatch, name, strategy,
                                    codec):
    """Two flushes of the heap runtime from ``make_run`` on PAMAP2_B2_SMALL:
    the fleets, masks and schedules exactly equal, every dispatch's upload
    rows S_up equal, histories exact (upload_mb to rtol 1e-9), losses to
    rtol 1e-4, the trainable to atol 1e-4."""
    (jrun, jsc), (trun, tsc) = _make_pair(b2_task, name, strategy,
                                          uplink_codec=codec,
                                          total_updates=8)
    _assert_fleets_equal(jsc.fleet, tsc.fleet)
    assert (jsc.schedule is None) == (tsc.schedule is None)
    ups = {}
    for mod in (JA, TA):
        orig = mod._selective_upload

        def wrapped(*a, _orig=orig, _log=ups.setdefault(mod, []), **k):
            out = _orig(*a, **k)
            _log.append(out.copy())
            return out

        monkeypatch.setattr(mod, "_selective_upload", wrapped)
    jh = jrun.run(jsc.dataset)
    th = trun.run(tsc.dataset)
    _assert_histories(jh, th, 2)
    assert len(ups[TA]) == len(ups[JA])
    assert bool(ups[TA]) == trun.strategy.selective
    for a, b in zip(ups[TA], ups[JA]):
        np.testing.assert_array_equal(a, b)
    _assert_trainable_close(jrun.state.trainable, trun.state.trainable, 1e-4)
    np.testing.assert_array_equal(trun.trace.per_client_updates,
                                  jrun.trace.per_client_updates)


def test_selective_upload_cuts_bytes_against_twin(b2_task):
    """fedmfs_selective is async_accessible plus the selective uploader:
    the same training and dispatch, so the same completions at less than
    0.75 of the twin's bytes, and a simulated clock no later."""
    params = b2_task[4]
    runs = {}
    for strategy in ("async_accessible", "fedmfs_selective"):
        spec = TSC.get_scenario("stream30", strategy=strategy,
                                total_updates=12, **B2)
        run, sc = TSC.make_run(spec, params=params, device="cpu")
        run.run(sc.dataset)
        runs[strategy] = run
    ref, sel = runs["async_accessible"], runs["fedmfs_selective"]
    assert sel.trace.completions == ref.trace.completions == 12
    assert sel.trace.upload_mb < 0.75 * ref.trace.upload_mb
    assert sel.state.sim_time <= ref.state.sim_time
    assert np.isfinite(sel.history["loss"]).all()


@pytest.mark.parametrize("strategy", ["async_relief", "fedmfs_selective"])
def test_stream_heap_and_vectorized_equal(b2_task, strategy):
    """Under the streaming schedule the port's heap and vectorized runtimes
    (grad mode "dispatch") dispatch the same (time, client) sequence with
    the same live masks: histories equal, losses and trainable close."""
    params = b2_task[4]
    spec = TSC.get_scenario("stream30", strategy=strategy, total_updates=16,
                            **B2)
    out = []
    for vec in (False, True):
        run, sc = TSC.make_run(spec, vec, params=params, device="cpu")
        assert isinstance(run, TA.VectorizedAsyncFedRun) == vec
        out.append((run, run.run(sc.dataset)))
    (h, hh), (v, vh) = out
    assert len(hh["flush"]) == 4
    for key in ("flush", "staleness_mean", "selected_frac", "sim_time_s",
                "energy_j"):
        assert vh[key] == hh[key], key
    # the vectorized trace adds a timestamp group's uploads in one sum
    np.testing.assert_allclose(vh["upload_mb"], hh["upload_mb"], rtol=1e-9)
    np.testing.assert_allclose(vh["loss"], hh["loss"], rtol=1e-5, atol=1e-6)
    for (p, a), (_, b) in zip(leaves_with_path(h.state.trainable),
                              leaves_with_path(v.state.trainable)):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-5, msg=p)


def test_determinism_under_churn_equals_reference():
    """System-only runs (grad mode "none") under churn and arrivals on a
    200-client streaming fleet: two port runs bit for bit equal, and equal
    to the reference's."""
    kw = dict(n_clients=200, grad_mode="none", jitter_sigma=0.1,
              total_updates=400, **B2)
    hists = []
    for mod in (TSC, TSC, JSC):
        spec = mod.get_scenario("stream30", **kw)
        extra = dict(params=None, device="cpu") if mod is TSC else {}
        run, _ = mod.make_run(spec, vectorized=True, churn_rate=0.5,
                              arrival_rate=0.5, **extra)
        run.run(None)
        assert (~run.fstate.alive).any()  # churn happened
        hists.append((run.history, run.fstate.updates.copy()))
    assert len(hists[0][0]["flush"]) >= 10
    for h, ups in hists[1:]:
        for key in ("flush", "sim_time_s", "staleness_mean",
                    "selected_frac", "energy_j", "upload_mb"):
            assert h[key] == hists[0][0][key], key
        np.testing.assert_array_equal(ups, hists[0][1])


def test_schedule_refusals_match_reference(b2_task):
    """Both runtimes refuse ``alloc="random"`` under a schedule and a
    schedule of another (N, M) than the fleet's, and the vectorized one
    selective upload outside grad mode "dispatch", as the reference's do;
    they take selective upload under a schedule."""
    from repro.core import strategies as JS

    jtask, jtr0, ttask, ttr0 = b2_task[:4]
    for A, SC, S, task, tr0 in ((JA, JSC, JS, jtask, jtr0),
                                (TA, TSC, TS, ttask, ttr0)):
        spec = SC.get_scenario("stream30", **B2)
        fleet = SC.build_fleet(spec)
        fed = A.AsyncFedConfig.from_scenario(spec, fleet=fleet)
        small = SC.streaming_schedule(np.ones((3, 4), bool), 0.3, 40.0, 0)
        for cls in (A.AsyncFedRun, A.VectorizedAsyncFedRun):
            with pytest.raises(ValueError, match="random"):
                cls.create(task, tr0, S.get("async_relief", alloc="random"),
                           fleet, fed)
            with pytest.raises(ValueError, match="does not match fleet"):
                cls.create(task, tr0, S.async_relief(), fleet,
                           dataclasses.replace(fed, modality_schedule=small))
            cls.create(task, tr0, S.fedmfs_selective(), fleet, fed)
        for mode in ("cohort", "none"):
            with pytest.raises(ValueError, match="selective upload"):
                A.VectorizedAsyncFedRun.create(
                    task, tr0, S.relief_selective(), fleet,
                    dataclasses.replace(fed, grad_mode=mode))
