"""The round's batch draw from the windows held on the run's device
(``engine.ResidentWindows``), against the host gather it replaced: the same
batches bit for bit and the same rng stream, at every draw site of the
sync and async runtimes; and a run builds its copy once, and again only
for another dataset object. CPU only; no JAX."""
from __future__ import annotations

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import async_engine as TA
from repro_torch.core import engine as EN
from repro_torch.core import strategies as TS
from repro_torch.core.tasks import MMTask
from repro_torch.data import make_har_dataset, mm_config_for
from repro_torch.sim import make_fleet

CFG = dict(backbone="cnn", d_feat=8, d_fused=32, cnn_ch=(8, 16))
KW = dict(local_epochs=1, steps_per_epoch=2, batch_size=4, eval_every=100,
          seed=3)
COUNTS = (7, 33, 2)  # three subjects of unequal window counts


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    ds = make_har_dataset("pamap2", windows_per_subject=60, seed=0)
    task, tr0 = MMTask.create(mm_config_for("pamap2", **CFG),
                              torch.Generator().manual_seed(0), device="cpu")
    # eight clients over three subjects: client n draws from n % 3
    unequal = SimpleNamespace(
        train_x=[x[:k] for x, k in zip(ds.train_x, COUNTS)],
        train_y=[y[:k] for y, k in zip(ds.train_y, COUNTS)])
    return task, tr0, make_fleet(3, 3, 2, M=4), unequal


def _plain(rng, ds, clients, steps, batch):
    """The host gather the draw replaced, one rng call per client."""
    xs, ys = [], []
    for n in clients:
        src = n % len(ds.train_y)
        idx = rng.integers(0, len(ds.train_y[src]), size=(steps, batch))
        xs.append(ds.train_x[src][idx])
        ys.append(ds.train_y[src][idx])
    return (torch.as_tensor(np.stack(xs)),
            torch.as_tensor(np.stack(ys), dtype=torch.int64))


def _plain_counter(seed, ds, ids, tickets, steps, batch):
    """The async runtime's counter-based host gather: one rng per (client,
    ticket)."""
    xs, ys = [], []
    for c, t in zip(ids, tickets):
        rng = np.random.default_rng([seed, int(c), int(t)])
        x, y = _plain(rng, ds, [int(c)], steps, batch)
        xs.append(x[0])
        ys.append(y[0])
    return torch.stack(xs), torch.stack(ys)


def _capture(run) -> dict:
    """Wrap the run's local update: the batches it is handed, and a copy
    of the run's rng as it stands then, just after the draw."""
    got, inner = {}, run.local_update

    def local_update(start, batches, *a, **kw):
        got["batches"] = batches
        got["rng"] = copy.deepcopy(run.state.rng)
        return inner(start, batches, *a, **kw)
    run.local_update = local_update
    return got


def _sync_round(task, tr0, fleet, ds):
    run = EN.FedRun.create(task, tr0, TS.get("relief"), fleet,
                           EN.FedConfig(rounds=1, **KW))
    before = copy.deepcopy(run.state.rng)  # relief draws nothing earlier
    got = _capture(run)
    run.round(ds)
    return got, _plain(before, ds, range(fleet.N), 2, 4), before


def _heap_dispatch(task, tr0, fleet, ds):
    run = TA.AsyncFedRun.create(task, tr0, TS.async_relief(), fleet,
                                TA.AsyncFedConfig(rounds=1, **KW))
    clients = np.array([6, 2, 4, 1])
    before = copy.deepcopy(run.state.rng)
    got = _capture(run)
    run._dispatch(clients, 0.0, ds)
    return got, _plain(before, ds, clients, 2, 4), before


def _vectorized_dispatch(task, tr0, fleet, ds):
    run = TA.VectorizedAsyncFedRun.create(task, tr0, TS.async_relief(),
                                          fleet,
                                          TA.AsyncFedConfig(rounds=1, **KW))
    idx = np.array([7, 0, 0, 5, 3, 7])  # repeats; 7, 5 and 3 wrap
    S = EN.allocate_rows(run.plan, run.strategy, run.state, idx)
    before = copy.deepcopy(run.state.rng)
    got = _capture(run)
    run._train_at_dispatch(idx, S, fleet.modality_mask[idx], None, ds)
    return got, _plain(before, ds, idx, 2, 4), before


def _counter(task, tr0, fleet, ds):
    fed = TA.AsyncFedConfig(rounds=1, grad_mode="cohort", **KW)
    run = TA.VectorizedAsyncFedRun.create(task, tr0, TS.async_relief(),
                                          fleet, fed)
    ids, tickets = np.array([0, 3, 3, 6]), np.array([1, 1, 2, 5])
    S = EN.allocate_rows(run.plan, run.strategy, run.state, ids)
    before = copy.deepcopy(run.state.rng)
    got = _capture(run)
    run._cohort_update(ds, ids, np.zeros(4, np.int64), tickets, S,
                       fleet.modality_mask[ids])
    want = _plain_counter(fed.seed, ds, ids, tickets, 2, 4)
    return got, want, before  # the run's own rng draws nothing here


@pytest.mark.parametrize("site", [_sync_round, _heap_dispatch,
                                  _vectorized_dispatch, _counter],
                         ids=["sync-unequal-wrap", "heap-dispatch",
                              "vectorized-repeats", "async-counter"])
def test_resident_draw_equals_the_host_gather(setup, site):
    """Each draw site hands the local update the batches the host gather
    gives from the same rng, bit for bit, contiguous and int64 labels; the
    run's rng then draws what the host gather's would next."""
    task, tr0, fleet, ds = setup
    got, (want_x, want_y), rng = site(task, tr0, fleet, ds)
    b = got["batches"]
    assert b["x"].dtype == want_x.dtype and b["y"].dtype == torch.int64
    assert b["x"].is_contiguous() and b["y"].is_contiguous()
    assert torch.equal(b["x"], want_x) and torch.equal(b["y"], want_y)
    assert got["rng"].integers(0, 2**62) == rng.integers(0, 2**62)


def test_run_builds_its_windows_once_and_again_for_another_dataset(setup):
    """Three profiled rounds on one dataset build the resident copy on the
    first draw only (``fed.draw``'s ``built``); a different dataset object
    with the same windows rebuilds it. ``h2d_bytes`` is the row indices'
    bytes, plus the windows' on a build."""
    from torch.profiler import ProfilerActivity, profile

    task, tr0, fleet, ds = setup
    run = EN.FedRun.create(task, tr0, TS.get("relief"), fleet,
                           EN.FedConfig(rounds=4, **KW))
    other = SimpleNamespace(train_x=list(ds.train_x),
                            train_y=list(ds.train_y))
    trace.clear()
    held = []
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for d in (ds, ds, ds, other):
                run.round(d)
                held.append(run.windows)
        draws = [r for r in trace.records() if r.name == "fed.draw"]
    finally:
        trace.clear()
    assert [r.attrs["built"] for r in draws] == [1, 0, 0, 1]
    assert held[0] is held[1] is held[2] and held[3] is not held[0]
    assert held[3].dataset is other
    rows = fleet.N * 2 * 4 * 8  # int64 row indices, one per label drawn
    windows = sum(x.nbytes for x in ds.train_x) + 8 * sum(COUNTS)
    assert held[0].nbytes == windows
    assert [r.attrs["h2d_bytes"] for r in draws] == [
        rows + windows, rows, rows, rows + windows]


def test_resumed_run_rebuilds_on_its_first_draw(setup):
    """The copy is never part of the run's saved state: a run rebuilt from
    the same weights holds none until it draws, and then draws what the
    first run drew from the same rng."""
    task, tr0, fleet, ds = setup
    fed = EN.FedConfig(rounds=1, **KW)
    first = EN.FedRun.create(task, tr0, TS.get("relief"), fleet, fed)
    a = first._round_batches(ds)
    second = EN.FedRun.create(task, tr0, TS.get("relief"), fleet, fed)
    assert second.windows is None
    b = second._round_batches(ds)
    assert second.windows is not first.windows
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
