"""The dropless expert layer's grouped products' share of their roofline
in the profiled steps: their least time on the H100 (``_moe_roofline``:
bytes of the experts that got a row and of the activations, 6 x rows x d x
f operations at the bf16 peak), over the device time of the product kernels
launched inside the program's ``moe.experts`` spans."""
import _moe_roofline as R


def read(obs):
    moe = (obs.get("profile") or {}).get("moe")
    if not moe:
        return None
    m = obs["config"]["model"]
    d, f = m["hidden_size"], m["intermediate_size"]
    t = sum(c[2] for c in moe["calls"])
    if t <= 0:
        return None
    return 100.0 * sum(R.experts_bound_s(d, f, a, load)
                       for a, load, _ in moe["calls"]) / t
