"""Host ms per engine step blocked on the card (every ``wait`` span: each
admission's first token, each decode step's next tokens), over the profiled
engine steps."""


def read(obs):
    try:
        from repro_torch import trace
    except ImportError:  # a program without spans
        return None
    recs = trace.records()
    n = sum(r.name == "engine.step" for r in recs)
    return 1e3 * sum(r.seconds for r in recs if r.kind == "wait") / n if n \
        else None
