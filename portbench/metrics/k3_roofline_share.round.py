"""Kernel 3's share of its roofline in the profiled round: the least time
its calls' bytes and operations need on the H100, over the device time of
its kernels (``fused_kernel``)."""
import re

import _roofline as R

PATTERN = re.compile(r"\bfused_kernel\b")


def read(obs):
    prof, calls = obs.get("profile"), obs.get("k3_calls")
    if not prof or not calls:
        return None
    t = sum(s for name, (_, s) in prof["kernels"].items()
            if PATTERN.search(name))
    if t <= 0:
        return None
    return 100.0 * sum(R.fused_bound_s(*c) for c in calls) / t
