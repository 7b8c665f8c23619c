# Kernels written by hand for Hopper (sm_90a), one package per TPU kernel
# family of ``repro.kernels``. Each package: csrc/ (CUDA sources), ops.py
# (device dispatch + launch counters), ref.py (plain PyTorch versions).
#   cohort_agg  fused cohort-masked aggregation + divergence (Eq. 3 + 5)
