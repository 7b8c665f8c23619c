"""The port's roofline and dry-run (``launch/roofline.py``,
``launch/dryrun.py``) against the JAX reference on the CPU: the H100
constants, collective counting on a (4, 2) mesh over the fake process
group (the numbers of the reference's ``test_roofline_collective_parser``),
``roofline_terms``, ``mdlora_block_plan`` and ``model_flops`` exactly,
per-device FLOPs of the replicated strategy, and a miniature ``run_cell``
in-process. Cells at production width run from the CLI
(``python -m repro_torch.launch.dryrun``), not here."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import torch.distributed._functional_collectives as funcol  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import roofline as JRL  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.dist import sharding as TSH  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import roofline as TRL  # noqa: E402


@pytest.fixture
def mesh42():
    """A (4, 2) DeviceMesh over the fake process group, destroyed on
    teardown (xdist runs files one after another in a worker)."""
    mesh = TM.make_fake_mesh((4, 2), ("data", "model"))
    yield mesh
    TSH.set_activation_mesh(None)
    TM.close_process_group()


def test_h100_constants():
    """H100 SXM5 80GB data-sheet values, not the TPU's."""
    assert TRL.PEAK_FLOPS == 989e12 and TRL.HBM_BW == 3.35e12
    assert TRL.LINK_BW == 450e9 and TRL.HBM_BYTES == 80e9
    assert TRL._COLLECTIVES == JRL._COLLECTIVES


def test_collective_counting_on_a_fake_mesh(mesh42):
    """An all-gather to bf16[16, 128] and an all-reduce of f32[8, 8]: the
    reference's parser counts 16*128*2 + 8*8*4*2 bytes (all-reduce twice)
    for the same two ops."""
    x = torch.ones(4, 128, dtype=torch.bfloat16)
    y = torch.ones(8, 8)
    with TRL.count_collectives() as c:
        g = funcol.all_gather_single(x, 0, (mesh42, 0))
        r = funcol.all_reduce(y, "sum", (mesh42, 1))
        g, r = g.wait() if hasattr(g, "wait") else g, r
    assert tuple(g.shape) == (16, 128)
    st = c.collectives
    assert st.counts == {"all-gather": 1, "all-reduce": 1}
    assert st.bytes_entry == 16 * 128 * 2 + 8 * 8 * 4 * 2
    assert st.bytes_scanned == 0 and st.total(3) == st.bytes_entry
    ref = JRL.parse_collectives("""
ENTRY main {
  %x = bf16[16,128]{1,0} all-gather(%a), replica_groups={}
  %y = f32[8,8]{1,0} all-reduce(%b), to_apply=%add
}
""")
    assert (ref.counts, ref.bytes_entry) == (st.counts, st.bytes_entry)


def test_roofline_terms():
    st = TRL.CollectiveStats(450, 0, {"all-gather": 2})
    t = TRL.roofline_terms(989e12, 2 * 3.35e12, st)
    assert t["t_compute_s"] == 1.0 and t["t_memory_s"] == 2.0
    assert t["t_collective_s"] == 1e-9 and t["dominant"] == "memory"
    assert t["collective_counts"] == {"all-gather": 2}
    assert set(t) == {"hlo_flops_per_device", "hlo_bytes_per_device",
                      "collective_bytes_per_device", "collective_counts",
                      "t_compute_s", "t_memory_s", "t_collective_s",
                      "dominant"}


SHAPES = [{"T": 256, "D": 112, "F": 128, "r": 8},
          {"T": 16, "D": 5120, "F": 5120, "r": 8, "multi": True,
           "n_adapters": 16},
          {"T": 16, "D": 5120, "F": 1280, "r": 8, "multi": True,
           "n_adapters": 16},
          {"T": 8, "D": 1600, "F": 320, "r": 8, "multi": True,
           "n_adapters": 4},
          {"T": 4096, "D": 4096, "F": 14336, "r": 16},
          {"T": 1, "D": 7, "F": 5, "r": 3}, {"T": 1024, "D": 96, "F": 130,
                                             "r": 4}]


def test_mdlora_block_plan_matches_reference():
    """Integer, flop, byte and intensity fields exactly; the t_* terms and
    the dominant side from the H100 constants."""
    want = JRL.mdlora_block_plan(SHAPES, impl="pallas", interpret=True)
    got = TRL.mdlora_block_plan(SHAPES)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("T", "D", "F", "r", "multi", "n_adapters", "bt", "bf",
                  "bd", "flops", "bytes", "intensity"):
            assert g[k] == w[k], k
        assert g["t_compute_s"] == g["flops"] / 989e12
        assert g["t_memory_s"] == g["bytes"] / 3.35e12
        assert g["dominant"] == ("compute" if g["t_compute_s"]
                                 >= g["t_memory_s"] else "memory")


@pytest.mark.parametrize("arch", tbase.list_archs())
def test_model_flops_match_reference(arch):
    """Every supported (shape x train mode): every key exactly."""
    jcfg, tcfg = jbase.get_arch(arch).FULL, tbase.get_arch(arch).FULL
    for js, ts in zip(jbase.ALL_SHAPES, tbase.ALL_SHAPES):
        if not tbase.supports(tcfg, ts):
            continue
        for mode in ("lora", "full"):
            assert TRL.model_flops(tcfg, ts, mode) == \
                JRL.model_flops(jcfg, js, mode)


def _mini(arch="granite-3-8b", **kw):
    cfg = dataclasses.replace(tbase.get_arch(arch).SMOKE, n_layers=2, **kw)
    return cfg, tbase.ShapeConfig("t", 64, 8, "train")


def test_replicated_flops_are_an_eighth(mesh42):
    """Replicated params, the batch of 8 over all 8 ranks: each rank's
    products are an eighth of one device's, exactly (FLOPs count the
    products; they all scale with the batch)."""
    cfg, shape = _mini(remat="full", loss_chunks=8)
    mod = tbase.get_arch("granite-3-8b")
    spread = dryrun._trace_step(cfg, mod, shape, mesh42, "lora",
                                "replicated")
    one = dryrun._trace_step(cfg, mod, shape, None, "lora", "replicated")
    assert spread["flops"] > 0 and one["flops"] == 8 * spread["flops"]
    assert 0 < spread["peak_bytes"] < one["peak_bytes"]
    assert spread["coll"].counts.get("all-reduce", 0) > 0
    assert not one["coll"].counts


@pytest.mark.parametrize("strategy,probes", [("fsdp", ()), ("tp", "skip"),
                                             ("replicated", "skip")])
def test_miniature_run_cell(mesh42, strategy, probes):
    """granite-3-8b SMOKE, 2 layers, S=64, B=8 on a (4, 2) mesh, in-process:
    status ok, memory recorded; for fsdp FLOPs above 0 and the full-depth
    counts equal to the probes' extrapolation within 1e-6 relative (tp and
    replicated trace the full depth only: DTensor plans tp's redistributions
    slowly on the host)."""
    cfg, shape = _mini()
    res = dryrun.run_cell("granite-3-8b", "t", False, mesh=mesh42, cfg=cfg,
                          shape=shape, strategy=strategy, probes=probes)
    assert res["status"] == "ok" and res["strategy"] == strategy
    assert res["n_chips"] == 8
    assert res["memory"]["peak_bytes"] > res["memory"]["argument_bytes"] > 0
    if probes == "skip":
        assert "roofline" not in res
        return
    r = res["roofline"]
    assert r["hlo_flops_per_device"] > 0 and r["hlo_bytes_per_device"] > 0
    assert r["collective_bytes_per_device"] > 0
    for k, gap in r["extrapolation_gap"].items():
        assert gap <= 1e-6, (k, gap)
    assert [p["layers"] for p in res["probes"]] == [1, 2]
    assert res["model_flops"] == TRL.model_flops(cfg, shape, "lora")


def test_unsupported_cell_is_skipped():
    res = dryrun.run_cell("phi3-medium-14b", "long_500k", False)
    assert res["status"] == "skipped" and "sub-quadratic" in res["reason"]


def test_kernels_refuse_fake_and_distributed_tensors(mesh42):
    """A fake tensor on a CUDA device (which needs no card) reaches the
    kernel path of an op and is refused before any launch; so is a
    DTensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import runtime
    from repro_torch.kernels.cohort_agg import ops as agg_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    with FakeTensorMode():
        x = torch.empty(4, 16, 8, device="cuda")
        W = torch.empty(4, 16, device="cuda")
        q = torch.empty(1, 2, 1, 2, 16, device="cuda")
        kv = torch.empty(1, 4, 1, 16, device="cuda")
        pos = torch.zeros(2, dtype=torch.int32, device="cuda")
        kvp = torch.zeros(4, dtype=torch.int32, device="cuda")
        with pytest.raises(TypeError, match="FakeTensor"):
            agg_ops.cohort_agg_divergence(x, W, W)
        with pytest.raises(TypeError, match="FakeTensor"):
            fa_ops.flash_attention(q, kv, kv, pos, kvp)
    d = TSH.distribute(mesh42, torch.ones(8, 4), TSH.replicated(mesh42))
    with pytest.raises(TypeError, match="DTensor"):
        runtime.check_cuda_tensor("x", d, torch.float32, (8, 4), d.device)
