from repro_torch.kernels.mdlora.ops import (block_row_mask, block_row_masks,
                                            mdlora_matmul, mdlora_matmul_multi)

__all__ = ["block_row_mask", "block_row_masks", "mdlora_matmul",
           "mdlora_matmul_multi"]
