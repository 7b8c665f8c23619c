from repro_torch.kernels.ssd.ops import ssd

__all__ = ["ssd"]
