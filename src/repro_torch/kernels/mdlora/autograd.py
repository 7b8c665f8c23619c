"""The Backbone 2 fusion projection as a differentiable function.

    y = (x*m) @ W0 + ((x*m) @ a) @ b * scale

The forward is ``ops.mdlora_matmul``: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors, so the CPU tests run this same Function. The
backward is plain PyTorch products, the gradient of the same expression
that the reference leaves to XLA to differentiate (the TPU kernel has no
backward kernel):

    g  = scale * dy @ bᵀ                 u  = (x*m) @ a
    dx = (dy @ W0ᵀ + g @ aᵀ) * m         da = (x*m)ᵀ @ g
    db = scale * uᵀ @ dy                 dW0 = (x*m)ᵀ @ dy (when asked)

Rows of ``da`` (and ``dx``) for absent blocks are exactly zero: their rows
of x*m are zero, whatever x holds there.

Local training runs ``torch.func.vmap(torch.func.grad_and_value(loss))``
over the clients. The forward hands raw pointers to the kernel, which a
BatchedTensor has not, so the Function carries its own ``vmap`` rule: the
batch axes go to the front and an operand that is not batched (the frozen
W0) stays 2-D, which the kernel reads with stride 0 -- one launch for all
clients. The backward runs at the grad level on BatchedTensors, so it stays
in PyTorch ops.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mdlora import ops
from repro_torch.kernels.mdlora.ref import acc_dtype


def _sum_to(t: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """Sum a leading batch axis away where the operand had none (an operand
    shared by every slice gets the sum of the slices' gradients)."""
    while t.dim() > len(shape):
        t = t.sum(0)
    return t


class FusedBlockLoRA(torch.autograd.Function):
    @staticmethod
    def forward(x, w0, a, b, row_mask, scale):
        return ops.mdlora_matmul(x, w0, a, b, row_mask, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w0, a, b, row_mask, scale = inputs
        ctx.save_for_backward(x, w0, a, b, row_mask)
        ctx.scale = scale

    @staticmethod
    def backward(ctx, dy):
        x, w0, a, b, m = ctx.saved_tensors
        acc = acc_dtype(x.dtype)
        dy = dy.to(acc)
        xm = x.to(acc) * m.to(acc).unsqueeze(-2)
        g = ctx.scale * (dy @ b.to(acc).mT)  # [.., T, r]
        dx = dw0 = da = db = None
        if ctx.needs_input_grad[0]:
            dx = (dy @ w0.to(acc).mT + g @ a.to(acc).mT) * m.to(
                acc).unsqueeze(-2)
            dx = _sum_to(dx, x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw0 = _sum_to(xm.mT @ dy, w0.shape).to(w0.dtype)
        if ctx.needs_input_grad[2]:
            da = _sum_to(xm.mT @ g, a.shape).to(a.dtype)
        if ctx.needs_input_grad[3]:
            u = xm @ a.to(acc)
            db = _sum_to(ctx.scale * (u.mT @ dy), b.shape).to(b.dtype)
        return dx, dw0, da, db, None, None

    @staticmethod
    def vmap(info, in_dims, x, w0, a, b, row_mask, scale):
        front = [t if d is None else t.movedim(d, 0).contiguous()
                 for t, d in zip((x, w0, a, b, row_mask), in_dims[:5])]
        return FusedBlockLoRA.apply(*front, scale), 0


def fused_block_lora(x, w0, a, b, row_mask, scale: float) -> torch.Tensor:
    """x [T, D] (or [K, T, D]); w0 [D, F]; a [D, r]; b [r, F]; row_mask [D]
    fp32 -> [T, F] in x's dtype, differentiable in x, a, b (and W0)."""
    return FusedBlockLoRA.apply(x, w0, a, b, row_mask, float(scale))
