"""Operations the card ran in the profiled round (kernels, copies and
sets), per round."""


def read(obs):
    prof, n = obs.get("profile"), obs.get("profiled_rounds")
    if not prof or not n:
        return None
    return prof["n_device_ops"] / n
