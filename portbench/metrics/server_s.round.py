"""Seconds per round in the server's steps: allocation, cohort
aggregation, divergence and group norms (outermost spans only),
synchronised, over the window's rounds outside the profiler."""

NAMES = ("allocate", "aggregate", "group_divergence", "group_norms")


def read(obs):
    n, spans = obs.get("span_rounds"), obs.get("span_total", {})
    if not n or not any(k in spans for k in NAMES):
        return None
    return sum(spans.get(k, 0.0) for k in NAMES) / n
