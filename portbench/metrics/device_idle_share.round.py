"""Share of the profiled round in which no operation ran on the card."""


def read(obs):
    prof = obs.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
