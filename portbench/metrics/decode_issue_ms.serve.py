"""Host ms per decode step in which the engine issues the step (span
``decode.issue``: the eager loop over the model's layers), over the
profiled engine steps."""


def read(obs):
    try:
        from repro_torch import trace
    except ImportError:  # a program without spans
        return None
    t = [r.seconds for r in trace.records() if r.name == "decode.issue"]
    return 1e3 * sum(t) / len(t) if t else None
