"""Model FLOPs of a round (``_roofline.b2_round_flops``) over the window's
mean round time outside the profiler, over the fp32 peak (67 TFLOP/s)."""
import _roofline as R


def read(obs):
    t = obs.get("round_s_spanned")
    if not t:
        return None
    flops = R.b2_round_flops(obs["config"]["model"], obs["traffic"])
    return 100.0 * flops / t / R.FP32_FLOPS_PER_S
