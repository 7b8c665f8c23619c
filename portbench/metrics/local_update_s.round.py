"""Seconds per round in the program's local update (``FedRun.local_update``:
every client's E x steps vmapped Adam steps), synchronised, over the
window's rounds outside the profiler."""


def read(obs):
    n = obs.get("span_rounds")
    t = obs.get("span_total", {}).get("local_update")
    return t / n if n and t is not None else None
