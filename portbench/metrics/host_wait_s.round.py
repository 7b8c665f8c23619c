"""Host seconds per round blocked on the card (every ``wait`` span: the
divergence's and group norms' copies to the host, the round's loss), over
the profiled round."""


def read(obs):
    try:
        from repro_torch import trace
    except ImportError:  # a program without spans
        return None
    recs = trace.records()
    n = sum(r.name == "fed.round" for r in recs)
    return sum(r.seconds for r in recs if r.kind == "wait") / n if n \
        else None
