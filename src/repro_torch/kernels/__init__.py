# Kernels written by hand for Hopper (sm_90a), one package per TPU kernel
# family of ``repro.kernels``. Each package: csrc/ (CUDA sources), ops.py
# (device dispatch + launch counters), ref.py (plain PyTorch versions).
#   cohort_agg       fused cohort-masked aggregation + divergence (Eq. 3 + 5)
#   flash_attention  online-softmax GQA attention (serving prefill/decode)
#   mdlora           fused block-LoRA projection (Backbone 2's fusion layer,
#                    differentiable) and its gathered multi-adapter form
#                    (serving engine)
#   ssd              Mamba-2 SSD chunked scan (recurrent families' prefill)
from repro_torch.kernels.cohort_agg.ops import (cohort_agg_divergence,
                                                cohort_agg_divergence_quant)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mdlora.ops import mdlora_matmul, mdlora_matmul_multi
from repro_torch.kernels.ssd.ops import ssd

__all__ = ["cohort_agg_divergence", "cohort_agg_divergence_quant",
           "flash_attention", "mdlora_matmul", "mdlora_matmul_multi", "ssd"]
