"""Host seconds per round that no named layer of the round covers: the span
``fed.round`` less its child spans (which do not overlap), over the
profiled round."""


def read(obs):
    try:
        from repro_torch import trace
    except ImportError:  # a program without spans
        return None
    recs = trace.records()
    rounds = [r for r in recs if r.name == "fed.round"]
    if not rounds:
        return None
    ids = {id(r) for r in rounds}
    kids = sum(r.seconds for r in recs
               if r.parent is not None and id(r.parent) in ids)
    return (sum(r.seconds for r in rounds) - kids) / len(rounds)
