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


def bf16_hi_lo(t: torch.Tensor) -> torch.Tensor:
    """t as the bf16 kernel feeds it to the tensor cores: hi + lo, each
    rounded to bf16 (to 2^-16 of t), summed in fp32."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def ssd_walk_ref(x, dt, A_log, Bm, Cm, chunk: int, initial_state=None,
                 p_block: int = 32, hi_lo: bool = False) -> tuple:
    """``ssd_ref`` in the order of the bf16 kernel's chunk walk: p in
    slices of ``p_block`` columns, each walking the chunks with its own
    state; the log-decays' running sums in fp64 (each difference rounded to
    fp32 once); dt folded into the derived operands, M = (C Bᵀ ⊙
    exp(cum_i - cum_j)) dt_j (j <= i) against x, and x w with w_j = dt_j
    exp(cum_last - cum_j) against B; y = M x + exp(cum) C stateᵀ. With
    ``hi_lo`` each derived operand and the carried state in C stateᵀ pass
    through ``bf16_hi_lo``, as the kernel's products read them.
    -> (y in x's dtype, final_state fp32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk != 0:
        raise ValueError(f"seq {s} not divisible by ssd chunk {chunk}")
    rnd = bf16_hi_lo if hi_lo else (lambda t: t)
    f = torch.float32
    xf, Bf, Cf, dtf = x.to(f), Bm.to(f), Cm.to(f), dt.to(f)
    a = -torch.exp(A_log.to(f)) * dtf  # [b, s, h], fp32 as the kernel
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    y = torch.empty((b, s, h, p), dtype=f, device=x.device)
    final = torch.empty((b, h, p, n), dtype=f, device=x.device)
    for q0 in range(0, p, p_block):
        q1 = min(p, q0 + p_block)
        state = (torch.zeros((b, h, q1 - q0, n), dtype=f, device=x.device)
                 if initial_state is None
                 else initial_state[:, :, q0:q1].to(f))
        for c in range(s // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            cum = torch.cumsum(a[:, sl].double(), dim=1)  # [b, Q, h]
            last = cum[:, -1]  # [b, h]
            G = torch.einsum("bin,bjn->bij", Cf[:, sl], Bf[:, sl])
            diff = (cum[:, :, None] - cum[:, None]).float()  # [b, i, j, h]
            L = torch.exp(diff.masked_fill(~tril, float("-inf")))
            M = G[..., None] * L * dtf[:, sl][:, None]
            xs = xf[:, sl, :, q0:q1]  # [b, Q, h, q]
            y_diag = torch.einsum("bijh,bjhq->bihq", rnd(M), xs)
            y_off = torch.einsum("bin,bhqn->bihq", Cf[:, sl], rnd(state))
            y[:, sl, :, q0:q1] = y_diag + \
                torch.exp(cum.float())[..., None] * y_off
            w = dtf[:, sl] * torch.exp((last[:, None] - cum).float())
            state = state * torch.exp(last.float())[..., None, None] + \
                torch.einsum("bjhq,bjn->bhqn", rnd(xs * w[..., None]),
                             Bf[:, sl])
        final[:, :, q0:q1] = state
    return y.to(x.dtype), final
