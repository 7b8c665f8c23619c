"""What every cell shares: spans timed by the benchmark around calls into
the program, the profiler's reading of a traced stretch, the device line
and the comparison of readings with their limits.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load_module(path: Path, name: str):
    """The module in ``path`` under ``name``, loaded once per process."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Spans:
    """Host-clock spans around calls into the program, each ending in a
    device synchronise. Only the outermost span of a nest counts, so a
    wrapped function that calls another wrapped one is timed once."""

    def __init__(self, device: torch.device):
        self.device = device
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}
        self.on = False
        self._depth = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def timed(*a, **kw):
            if not self.on or self._depth:
                self._depth += 1
                try:
                    return fn(*a, **kw)
                finally:
                    self._depth -= 1
            self._sync()
            t0 = time.perf_counter()
            self._depth += 1
            try:
                out = fn(*a, **kw)
                self._sync()
            finally:
                self._depth -= 1
            self.total[name] = self.total.get(name, 0.0) + (
                time.perf_counter() - t0)
            self.count[name] = self.count.get(name, 0) + 1
            return out
        return timed

    def patch(self, owner, attr: str) -> None:
        """Put the span named ``attr`` around ``owner.attr``."""
        setattr(owner, attr, self.wrap(attr, getattr(owner, attr)))


class Recorder:
    """Records the arguments' shapes of a program call while ``on``."""

    def __init__(self):
        self.calls: list[tuple] = []
        self.on = False

    def wrap(self, fn, describe):
        @functools.wraps(fn)
        def rec(*a, **kw):
            if self.on:
                self.calls.append(describe(*a, **kw))
            return fn(*a, **kw)
        return rec


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------


def _union(intervals: list[tuple[float, float, str]]) -> tuple[float, list]:
    """-> (covered length, the gaps between covered stretches as (start,
    end, name of the operation that ends the gap))."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, name in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            total += cur_e - cur_s
            gaps.append((cur_e, s, name))
            cur_s, cur_e = s, e
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def profile(fn, device: torch.device):
    """Run ``fn`` under torch.profiler with CUDA activity only (no
    per-op host records, which would slow the host and so inflate the
    idle share) -> (the profiler, the traced window's seconds). Read it
    with ``summary`` once the measured window has closed."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize(device)
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return prof, window_s


def whole_window(device: torch.device):
    """A profiler, CUDA activity only, to hold over a whole measured window;
    read it with ``device_busy`` once it has stopped."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize(device)
    return tprofile(activities=[ProfilerActivity.CUDA])


def device_busy(prof) -> float:
    """Seconds in which an operation ran on the card in a stopped profiler:
    the union of the device activity intervals, from the raw events (a whole
    window holds too many to parse as ``summary`` does)."""
    from torch.autograd import DeviceType

    s, e = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            s.append(ev.start_ns())
            e.append(ev.end_ns())
    if not s:
        return 0.0
    s, e = np.asarray(s, np.int64), np.asarray(e, np.int64)
    order = np.argsort(s, kind="stable")
    s, reach = s[order], np.maximum.accumulate(e[order])
    first = np.flatnonzero(np.r_[True, s[1:] > reach[:-1]])
    last = np.r_[first[1:] - 1, len(s) - 1]
    return float((reach[last] - s[first]).sum()) * 1e-9


def short(name: str) -> str:
    """A kernel's name without its return type and namespaces, cut to 110
    characters."""
    for cut in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(cut, "")
    return name[:110]


def summary(prof, window_s: float) -> dict:
    """{"window_s", "busy_s", "kernels": {name: [count, seconds]},
    "n_device_ops", "device_ops", "idle_gaps"}: ``busy_s`` is the union
    of the device activity intervals; each of the longest idle gaps is
    named by the operation the host launched to end it."""
    from torch.autograd import DeviceType

    dev_iv, kernels = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        dev_iv.append((s, e, ev.name))
        k = kernels.setdefault(ev.name, [0, 0.0])
        k[0] += 1
        k[1] += e - s
    busy, gaps = _union(dev_iv)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"window_s": window_s, "busy_s": busy, "kernels": kernels,
            "n_device_ops": len(dev_iv),
            "device_ops": [[short(n), v[1]] for n, v in top],
            "idle_gaps": [["host, then " + short(n), g1 - g0]
                          for g0, g1, n in longest]}


# ---------------------------------------------------------------------------
# the device line
# ---------------------------------------------------------------------------


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def device_line(count: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def checks(readings: dict, limits: dict) -> dict:
    """{name: value} against {name: limit}: a reading passes when it is at
    most its limit; a missing or non-finite reading fails."""
    out = {}
    for name, limit in limits.items():
        v = readings.get(name)
        ok = v is not None and v == v and v <= limit
        out[name] = {"value": v, "limit": limit, "ok": bool(ok)}
    return out


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)
