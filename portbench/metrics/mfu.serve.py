"""Model FLOPs of the tokens the engine processed in the traced window
(each admitted prompt token's prefill and each decoded row, at its
context) over the window, over the bf16 peak (989 TFLOP/s)."""
import _roofline as R


def read(obs):
    w, work = obs.get("window_s"), obs.get("work")
    if not w or not work or not work["rows"]:
        return None
    m = obs["config"]["model"]
    flops = (R.lm_flops(m, work["prompt"], work["prompt_ctx"])
             + R.lm_flops(m, work["rows"], work["row_ctx"]))
    return 100.0 * flops / w / R.BF16_FLOPS_PER_S
