"""Plain PyTorch version of the Mamba-2 SSD chunked scan: the reference's
XLA path (``models/ssm.py`` ``ssd_chunked``), which is also the oracle of
its Pallas kernel.

Per chunk of Q steps: the intra-chunk term is the quadratic (dual,
attention-like) form ``(C·Bᵀ ⊙ exp(cum_i - cum_j), i >= j) · (x·dt)``;
the carried state adds ``exp(cum) · C · stateᵀ``; the state then decays to
the chunk's end and takes the chunk's inputs. Everything runs in fp32 and
y is cast to x's dtype. A Python loop over chunks takes the place of
``lax.scan``.
"""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
            initial_state: torch.Tensor | None = None,
            compute_dtype: torch.dtype = torch.float32) -> tuple:
    """x [b, s, h, p]; dt [b, s, h] (softplus-ed step sizes); A_log [h]
    (log of -A); Bm, Cm [b, s, n] (one group, shared by the heads);
    initial_state [b, h, p, n] or None (zeros).
    -> (y [b, s, h, p] in x's dtype, final_state [b, h, p, n] in
    ``compute_dtype``: fp32 as the reference; fp64 gives a yardstick of the
    fp32 versions' rounding)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk != 0:
        raise ValueError(f"seq {s} not divisible by ssd chunk {chunk}")
    nc = s // chunk
    ct = compute_dtype

    a = -torch.exp(A_log.to(ct)) * dt.to(ct)  # [b, s, h] log-decay
    xd = x.to(ct) * dt.to(ct)[..., None]  # dt-weighted input

    ac = a.reshape(b, nc, chunk, h)
    xc = xd.reshape(b, nc, chunk, h, p)
    Bc = Bm.to(ct).reshape(b, nc, chunk, n)
    Cc = Cm.to(ct).reshape(b, nc, chunk, n)

    cum = torch.cumsum(ac, dim=2)  # [b, nc, q, h]
    # intra-chunk decay L[i, j] = exp(cum_i - cum_j), i >= j. The mask goes
    # on in the log domain, before exp: the upper triangle holds large
    # positive values whose exp is inf, and inf * 0 is NaN
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b, nc, q, k, h]
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    diff = diff.masked_fill(~tril[None, None, :, :, None], float("-inf"))
    Lmat = torch.exp(diff)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    # explicit contraction order: a free einsum path may materialize the
    # [b, c, q, k, h, p] product
    sl = scores[..., None] * Lmat  # [b, nc, q, k, h]
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", sl, xc)

    # per-chunk end states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [b, nc, q, h]
    xde = xc * decay_to_end[..., None]  # [b, nc, q, h, p]
    chunk_states = torch.einsum("bcqn,bcqhp->bchpn", Bc, xde)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [b, nc, h]

    # inter-chunk recurrence, one chunk at a time
    state = (torch.zeros((b, h, p, n), dtype=ct, device=x.device)
             if initial_state is None else initial_state.to(ct))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)  # [b, nc, h, p, n]

    state_decay = torch.exp(cum)  # decay from the chunk's start to q
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, prev_states) \
        * state_decay[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), state
