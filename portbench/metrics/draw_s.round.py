"""Host seconds per round in the program's batch draw (span ``fed.draw``:
every client's batches gathered on the host and copied to the card from
pageable memory), over the profiled round."""


def read(obs):
    try:
        from repro_torch import trace
    except ImportError:  # a program without spans
        return None
    recs = trace.records()
    n = sum(r.name == "fed.round" for r in recs)
    return sum(r.seconds for r in recs if r.name == "fed.draw") / n if n \
        else None
