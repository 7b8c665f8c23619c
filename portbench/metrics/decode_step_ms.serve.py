"""Mean of the engine's own decode-step times (``step_times``, each ending
on the host) in the window, in ms."""


def read(obs):
    st = obs.get("step_times")
    return 1e3 * sum(st) / len(st) if st else None
