"""Host seconds per round in which the program issues the local update
(span ``fed.local_update``: the host launching the vmapped steps), over the
profiled round."""


def read(obs):
    try:
        from repro_torch import trace
    except ImportError:  # a program without spans
        return None
    recs = trace.records()
    n = sum(r.name == "fed.round" for r in recs)
    if not n:
        return None
    return sum(r.seconds for r in recs if r.name == "fed.local_update") / n
