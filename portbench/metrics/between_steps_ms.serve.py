"""Mean host ms from the end of one engine step (span ``engine.step``) to
the start of the next: time outside the engine, in the caller's loop, over
the profiled engine steps."""


def read(obs):
    try:
        from repro_torch import trace
    except ImportError:  # a program without spans
        return None
    steps = [r for r in trace.records() if r.name == "engine.step"]
    if len(steps) < 2:
        return None
    return 1e-6 * sum(b.start - a.end for a, b in zip(steps, steps[1:])) \
        / (len(steps) - 1)
