# Model configurations (``ModelConfig``) and the registry of the ported
# architectures: ``get_arch(name).FULL`` / ``.SMOKE``.
from repro_torch.configs.base import ModelConfig, get_arch, list_archs

__all__ = ["ModelConfig", "get_arch", "list_archs"]
