"""The most rows any expert got over the mean, per call of an expert
layer (one layer of one step or admission), from the ``load`` the
program's ``moe.experts`` spans keep; the median over the profiled steps'
calls. 1 is a perfect balance; 8 experts give at most 8."""
import statistics


def read(obs):
    moe = (obs.get("profile") or {}).get("moe")
    if not moe or not moe["calls"]:
        return None
    return statistics.median(max(load) * len(load) / a
                             for a, load, _ in moe["calls"])
