from repro_torch.kernels.cohort_agg.ops import (cohort_agg_divergence,
                                                cohort_agg_divergence_quant)

__all__ = ["cohort_agg_divergence", "cohort_agg_divergence_quant"]
