"""Mean time of one admission (``ServingEngine._admit``: the prompt's
prefill into a fresh row, the row's copy and the first token on the host),
synchronised, in ms."""


def read(obs):
    n = obs.get("span_count", {}).get("admit")
    return 1e3 * obs["span_total"]["admit"] / n if n else None
