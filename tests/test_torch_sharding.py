"""The port's distribution layer against the JAX reference on the CPU:
``dist/sharding.py``'s spec trees, leaf by leaf, against the reference's
PartitionSpec trees translated to DTensor placements (all ten FULL
architectures, train and serve, params / optimizer state / batches /
caches, on the reference's three-axis fake mesh and on (16, 16) and
(2, 16, 16) fake mesh objects); ``pick_strategy``, ``input_specs`` and
``supports`` exactly; ``act_hint`` on a (4, 2) mesh over the fake process
group; ``launch/mesh.py``; and ``models/layers.py`` ``attention`` with and
without a KV ring."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.dist import sharding as JSH  # noqa: E402
from repro.launch import step_fns as JSF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.dist import sharding as TSH  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import step_fns as TSF  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCHS = tbase.list_archs()
MESHES = {"pod3": ((2, 16, 16), ("pod", "data", "model")),
          "single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class JMesh:  # the reference's FakeMesh (tests/test_sharding_dryrun.py)
    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


class TMesh:  # the same mesh as a DeviceMesh presents it
    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape


@pytest.fixture
def fake_group():
    """A (4, 2) DeviceMesh over the fake process group, destroyed on
    teardown (xdist runs files one after another in a worker)."""
    mesh = TM.make_fake_mesh((4, 2), ("data", "model"))
    yield mesh
    TSH.set_activation_mesh(None)
    TM.close_process_group()


def _placements(spec, names) -> tuple:
    """A reference PartitionSpec -> one placement per mesh dim."""
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        for axis in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


def _jleaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(p): x for p, x in flat}


def _same(jtree, ttree, names) -> None:
    want = {k: _placements(v, names) for k, v in _jleaves(jtree).items()}
    got = dict(leaves_with_path(ttree))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k]) == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_reference(arch, mesh):
    """param_specs (train and serve, every strategy), opt_state_specs
    (LoRA and full), batch_specs of every shape's inputs and cache_specs of
    the decode caches, leaf by leaf."""
    shape, names = MESHES[mesh]
    jm, tm = JMesh(shape, names), TMesh(shape, names)
    jcfg, tcfg = jbase.get_arch(arch).FULL, tbase.get_arch(arch).FULL
    jp, tp = JSF.abstract_params(jcfg), TSF.abstract_params(tcfg)
    for kind in ("train", "serve"):
        for strat in (None, "fsdp", "tp", "replicated"):
            js = JSH.param_specs(jcfg, jp, jm, train=kind == "train",
                                 strategy=strat)
            ts = TSH.param_specs(tcfg, tp, tm, train=kind == "train",
                                 strategy=strat)
            _same(js, ts, names)
    js = JSH.param_specs(jcfg, jp, jm, train=True, strategy="fsdp")
    ts = TSH.param_specs(tcfg, tp, tm, train=True, strategy="fsdp")
    for mode in ("lora", "full"):
        jtr, _ = JSF.split_trainable(jp, mode)
        ttr, _ = TSF.split_trainable(tp, mode)
        jo, to = JSF.abstract_opt_state(jtr), TSF.abstract_opt_state(ttr)
        pick = (lambda s: s["lora"]) if mode == "lora" else (lambda s: s)
        _same(JSH.opt_state_specs(pick(js), jo, jm),
              TSH.opt_state_specs(pick(ts), to, tm), names)
    for s in jbase.ALL_SHAPES:
        if not jbase.supports(jcfg, s):
            continue
        jb = jbase.get_arch(arch).input_specs(s, jcfg)
        tb = tbase.get_arch(arch).input_specs(tbase.SHAPES[s.name], tcfg)
        for strat in (None, "fsdp", "tp", "replicated"):
            _same(JSH.batch_specs(jb, jm, jcfg, strat),
                  TSH.batch_specs(tb, tm, tcfg, strat), names)
    jc = JSF.abstract_caches(jcfg, 128, 4096)
    tc = TSF.abstract_caches(tcfg, 128, 4096)
    _same(JSH.cache_specs(jcfg, jc, jm), TSH.cache_specs(tcfg, tc, tm),
          names)


@pytest.mark.parametrize("arch", ARCHS)
def test_strategy_and_param_count_match_reference(arch):
    jcfg, tcfg = jbase.get_arch(arch).FULL, tbase.get_arch(arch).FULL
    assert TSH._approx_param_count(tcfg) == JSH._approx_param_count(jcfg)
    for kind in ("train", "prefill", "decode", "serve"):
        assert TSH.pick_strategy(tcfg, kind) == JSH.pick_strategy(jcfg, kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_supports_match_reference(arch):
    """Every (arch x shape): ``supports`` equal; where supported, the same
    keys, shapes and dtypes, on ``meta`` (no memory)."""
    jmod, tmod = jbase.get_arch(arch), tbase.get_arch(arch)
    assert [s.name for s in tbase.ALL_SHAPES] == [s.name for s in
                                                   jbase.ALL_SHAPES]
    for js, ts in zip(jbase.ALL_SHAPES, tbase.ALL_SHAPES):
        assert dataclasses.astuple(ts) == dataclasses.astuple(js)
        ok = tbase.supports(tmod.FULL, ts)
        assert ok == jbase.supports(jmod.FULL, js)
        if not ok:
            continue
        want = jmod.input_specs(js)
        got = tmod.input_specs(ts)
        assert set(got) == set(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), (arch, k)
            assert str(got[k].dtype).split(".")[-1] == str(v.dtype), (arch, k)
            assert got[k].device.type == "meta"
        assert tbase.lm_input_specs(tmod.FULL, ts).keys() == \
            jbase.lm_input_specs(jmod.FULL, js).keys()


def test_act_hint_without_mesh_is_identity():
    TSH.set_activation_mesh(None)
    x = torch.ones(4, 8)
    assert TSH.act_hint(x, "batch", "model") is x
    assert TSH.reduce_partial(x) is x


def test_act_hint_on_a_fake_mesh(fake_group):
    """With a mesh installed a DTensor is redistributed to the placements
    its labels resolve to; an axis that does not divide its dim is
    dropped; no sharded dim leaves it as it is; plain tensors pass."""
    mesh = fake_group
    x = TSH.distribute(mesh, torch.empty(8, 6, 16, device="meta"),
                       TSH.replicated(mesh), local=True)
    TSH.set_activation_mesh(mesh, tp=True)
    y = TSH.act_hint(x, "batch", None, "model")
    assert isinstance(y, DTensor)
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert tuple(y.to_local().shape) == (2, 6, 8)
    # 5 is not a multiple of the model axis (2): that label is dropped
    z = TSH.distribute(mesh, torch.empty(8, 5, device="meta"),
                       TSH.replicated(mesh), local=True)
    assert tuple(TSH.act_hint(z, "batch", "model").placements) == \
        (Shard(0), Replicate())
    assert TSH.act_hint(z, None, None) is z
    TSH.set_activation_mesh(mesh, tp=False)
    assert tuple(TSH.act_hint(x, "batch", None, "model").placements) == \
        (Shard(0), Replicate())
    TSH.set_activation_mesh(mesh, tp=True, batch_axes=("data", "model"))
    assert tuple(TSH.act_hint(x, "batch", None, None).placements) == \
        (Shard(0), Shard(0))
    plain = torch.ones(8, 6)
    assert TSH.act_hint(plain, "batch", "model") is plain


def test_dtensor_helpers_on_a_fake_mesh(fake_group):
    """``whole_heads`` replicates a dim whose shards would split heads,
    ``replicate_dim`` a sharded dim, ``gather_weight`` the data axes of an
    FSDP shard (the model axis stays); all return plain tensors, and any
    tensor without a mesh, as they are."""
    mesh = fake_group
    TSH.set_activation_mesh(mesh)

    def dt(shape, spec):
        return TSH.distribute(mesh, torch.empty(shape, device="meta"), spec,
                              local=True)

    x = dt((8, 4, 24), (Replicate(), Shard(2)))  # 24 over the model axis
    assert TSH.whole_heads(x, 6) is x  # 6 heads over 2 shards: whole
    y = TSH.whole_heads(x, 3)  # 3 heads over 2 shards: one would split
    assert tuple(y.placements) == (Replicate(), Replicate())
    z = dt((8, 4, 24), (Shard(0), Shard(2)))
    assert tuple(TSH.replicate_dim(z, -1).placements) == (Shard(0),
                                                          Replicate())
    assert TSH.replicate_dim(z, 1) is z
    w = dt((16, 8), (Shard(0), Shard(1)))
    assert tuple(TSH.gather_weight(w).placements) == (Replicate(), Shard(1))
    plain = torch.ones(3, 4)
    for fn in (lambda t: TSH.whole_heads(t, 3), TSH.gather_weight,
               TSH.reduce_partial, lambda t: TSH.replicate_dim(t, 0)):
        assert fn(plain) is plain
    TSH.set_activation_mesh(None)
    assert TSH.gather_weight(w) is w and TSH.whole_heads(x, 3) is x


def test_distribute_applies_specs(fake_group):
    mesh = fake_group
    w = torch.arange(64 * 12, dtype=torch.float32).reshape(64, 12)
    spec = TSH.param_specs(tbase.get_arch("phi3-medium-14b").SMOKE,
                           {"w": w}, mesh, train=True, strategy="fsdp")
    assert spec["w"] == (Shard(0), Replicate())
    named = TSH.to_named(mesh, spec)
    assert named["w"] == (mesh, (Shard(0), Replicate()))
    d = TSH.distribute(mesh, {"w": w}, spec)["w"]
    assert isinstance(d, DTensor) and tuple(d.shape) == (64, 12)
    assert tuple(d.to_local().shape) == (16, 12)
    b = TSH.batch_specs({"t": torch.empty(8, 3)}, mesh, None, "fsdp")
    assert b["t"] == (Shard(0), Shard(0))
    b = TSH.batch_specs({"t": torch.empty(4, 3)}, mesh, None, "fsdp")
    assert b["t"] == (Shard(0), Replicate())
    b = TSH.batch_specs({"t": torch.empty(3, 3)}, mesh, None, "fsdp")
    assert b["t"] == (Replicate(), Replicate())


@pytest.mark.parametrize("multi", [False, True])
def test_production_meshes(multi):
    """The reference's shapes and axis names over the fake group; the
    group is opened when none is and closed here."""
    try:
        m = TM.make_production_mesh(multi_pod=multi)
        want = ((2, 16, 16), ("pod", "data", "model")) if multi else \
            ((16, 16), ("data", "model"))
        assert (tuple(m.shape), tuple(m.mesh_dim_names)) == want
        assert m.size() == (512 if multi else 256)
        assert m.device_type == "cpu"
        with pytest.raises(RuntimeError, match="ranks is open"):
            TM.make_fake_mesh((4, 2), ("data", "model"))
    finally:
        TM.close_process_group()


def test_host_mesh_names_the_cards_present():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mp in (1, 2):
        with pytest.raises(ValueError, match="0 present"):
            TM.make_host_mesh(mp)


# ---------------------------------------------------------------------------
# models/layers.py attention
# ---------------------------------------------------------------------------

DIMS = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)


def _attn_inputs(seed, B=2, S=8):
    g = np.random.default_rng(seed)
    d, H, K, hd = (DIMS[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                     "head_dim"))
    shapes = {"wq": (d, H * hd), "wk": (d, K * hd), "wv": (d, K * hd),
              "wo": (H * hd, d)}
    p = {k: (g.normal(size=s) / 8).astype(np.float32)
         for k, s in shapes.items()}
    x = g.normal(size=(B, S, d)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("window,softcap,qscale", [(None, None, None),
                                                   (5, 30.0, None),
                                                   (None, None, 0.3)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_matches_reference(window, softcap, qscale, impl):
    """``attention`` without a cache and with a 16-slot KV ring (two steps:
    a prefill of 8 positions, then one token at position 8, ring slots
    past the fill empty), at rtol 1e-5; "pallas" is the flash op's plain
    version on the CPU, held against the reference's XLA path."""
    p, x = _attn_inputs(3)
    kw = dict(window=window, rope_theta=10000.0, attn_softcap_val=softcap,
              query_scale=qscale, q_chunk=4)
    jd, td = JL.AttnDims(**DIMS), TL.AttnDims(**DIMS)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    pos = np.arange(8, dtype=np.int32)
    want, _ = JL.attention(jp, jd, jnp.asarray(x), jnp.asarray(pos), **kw)
    got, none = TL.attention(tp, td, torch.as_tensor(x), torch.as_tensor(pos),
                             attn_impl=impl, **kw)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    B, T, K, hd = 2, 16, DIMS["n_kv_heads"], DIMS["head_dim"]
    jc = {"k": jnp.zeros((B, T, K, hd)), "v": jnp.zeros((B, T, K, hd)),
          "pos": jnp.full((T,), -1, jnp.int32)}
    tc = {"k": torch.zeros(B, T, K, hd), "v": torch.zeros(B, T, K, hd),
          "pos": torch.full((T,), -1, dtype=torch.int32)}
    _, x2 = _attn_inputs(4, S=1)
    for xs, ps in ((x, pos), (x2, np.array([8], np.int32))):
        want, jc = JL.attention(jp, jd, jnp.asarray(xs), jnp.asarray(ps),
                                kv_cache=jc, **kw)
        before = tc["k"].clone()
        got, tc2 = TL.attention(tp, td, torch.as_tensor(xs),
                                torch.as_tensor(ps), kv_cache=tc,
                                attn_impl=impl, **kw)
        assert torch.equal(tc["k"], before)  # the cache is updated in a copy
        tc = tc2
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        for k in ("k", "v", "pos"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=1e-6)
