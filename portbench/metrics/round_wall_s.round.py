"""Host seconds per round: the mean of the window's rounds outside the
profiler, each ended by a device synchronise. The host paces the round, and
its speed swings from run to run too widely for this to carry a bound."""


def read(obs):
    return obs.get("round_s_spanned")
