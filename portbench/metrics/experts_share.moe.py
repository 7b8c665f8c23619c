"""Share of the profiled steps' device busy time spent in the dropless
expert layer's dispatch, grouped products and combine: the kernels launched
inside the program's ``moe.experts`` and ``moe.combine`` spans, in %."""


def read(obs):
    prof = obs.get("profile")
    moe = (prof or {}).get("moe")
    if not moe or prof["busy_s"] <= 0:
        return None
    s = moe["span_s"]
    return 100.0 * (s["moe.experts"] + s["moe.combine"]) / prof["busy_s"]
