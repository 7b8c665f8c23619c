"""Kernel 4's share of its roofline in the profiled decode steps: the least
time its calls' bytes and operations need on the H100, over the device
time of its kernels (``bf16_kernel``; fp32 ``partial_kernel`` and
``finish_kernel``)."""
import re

import _roofline as R

PATTERN = re.compile(r"\bbf16_kernel\b|\bpartial_kernel\b|\bfinish_kernel\b")


def read(obs):
    prof, calls = obs.get("profile"), obs.get("k4_calls")
    if not prof or not calls:
        return None
    t = sum(s for name, (_, s) in prof["kernels"].items()
            if PATTERN.search(name))
    if t <= 0:
        return None
    return 100.0 * sum(R.multi_bound_s(*c) for c in calls) / t
