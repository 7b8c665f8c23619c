"""Plain PyTorch reference of RELIEF's synchronous round (Algorithm 1) on the
paper's Backbone 2, written from the paper (Sec. III-IV, VI-A3) and
independent of the program.

Model: per modality a frozen patch transformer (pre-RMSNorm with (1 + w)
weights, bidirectional softmax attention, SiLU-gated MLP) with LoRA on Q, V
and the MLP's up projection, mean-pooled and projected to d_m; the
concatenation h = [h_1; ...; h_M] (absent modalities zeroed) goes through
the fusion projection (h*m) @ W0 + ((h*m) @ a) @ b * alpha/r, whose ``a``
rows are the modality blocks of Eq. 1, then a two-layer ReLU head.

Round: Eq. 7's elastic budgets and top-k allocation by the smoothed
divergence (fusion blocks of held modalities mandatory); every client's
E x steps Adam steps on its own batches, with gradients and the returned
update gated to its selected groups; the cohort-wise masked mean of Eq.
3-4; the divergence of Eq. 5 over possession cohorts and its EMA (Eq. 6).

All N clients step together: the trainable leaves carry a leading client
axis and one backward of the summed per-client losses gives each client
its own gradient. Products run in fp32 with TF32 off; ``precision="tf32"``
is the control one step below (on a card TF32 products everywhere, on the
CPU the forward operands rounded to TF32), and ``"fp64"`` the witness one
step above.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# configuration and parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class B2:
    modalities: tuple  # ((name, channels, d_feat, kind), ...) in model order
    window: int
    patch: int
    enc_layers: int
    enc_d: int
    enc_heads: int
    enc_ff: int
    d_fused: int
    head_hidden: int
    n_classes: int
    lora_rank: int
    lora_alpha: float

    @classmethod
    def from_config(cls, c: dict) -> B2:
        mods = tuple((m["name"], m["channels"], m["d_feat"], m["kind"])
                     for m in c["modalities"])
        return cls(mods, c["window"], c["patch"], c["enc_layers"],
                   c["enc_d"], c["enc_heads"], c["enc_ff"], c["d_fused"],
                   c["head_hidden"], c["n_classes"], c["lora_rank"],
                   float(c["lora_alpha"]))

    @property
    def M(self) -> int:
        return len(self.modalities)

    @property
    def D(self) -> int:
        return sum(m[2] for m in self.modalities)

    @property
    def scale(self) -> float:
        return self.lora_alpha / self.lora_rank


def param_specs(b: B2) -> list[tuple[tuple, tuple[int, ...], float]]:
    """(path, shape, std) of every parameter, std 0 for zeros: dense
    weights N(0, 1/fan_in), LoRA a N(0, 1/in) and b = 0, norm weights 0."""
    d, L, ff, r = b.enc_d, b.enc_layers, b.enc_ff, b.lora_rank
    s = []
    for name, ch, dm, _ in b.modalities:
        e = ("base", "encoders", name)
        s.append((e + ("patch",), (b.patch * ch, d), 1 / math.sqrt(b.patch * ch)))
        for w, shape in (("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                         ("wo", (d, d))):
            s.append((e + ("layers", "attn", w), (L,) + shape, 1 / math.sqrt(d)))
        for w, shape, fan in (("wi", (d, ff), d), ("wg", (d, ff), d),
                              ("wo", (ff, d), ff)):
            s.append((e + ("layers", "mlp", w), (L,) + shape, 1 / math.sqrt(fan)))
        s.append((e + ("layers", "ln1"), (L, d), 0.0))
        s.append((e + ("layers", "ln2"), (L, d), 0.0))
        s.append((e + ("proj",), (d, dm), 1 / math.sqrt(d)))
    s.append((("base", "fusion_w0"), (b.D, b.d_fused), 1 / math.sqrt(b.D)))
    s.append((("base", "head", "w1"), (b.d_fused, b.head_hidden),
              1 / math.sqrt(b.d_fused)))
    s.append((("base", "head", "w2"), (b.head_hidden, b.n_classes),
              1 / math.sqrt(b.head_hidden)))
    s.append((("lora", "fusion", "a"), (b.D, r), 1 / math.sqrt(b.D)))
    s.append((("lora", "fusion", "b"), (r, b.d_fused), 0.0))
    for name, *_ in b.modalities:
        for t, dout in (("wq", d), ("wv", d), ("wi", ff)):
            p = ("lora", "encoders", name, "layers", t)
            s.append((p + ("a",), (L, d, r), 1 / math.sqrt(d)))
            s.append((p + ("b",), (L, r, dout), 0.0))
    return s


def trainable_paths(flat: dict) -> list[tuple]:
    """The trained leaves: every LoRA leaf and the head."""
    return sorted(p for p in flat
                  if p[0] == "lora" or p[:2] == ("base", "head"))


def trainable_key(p: tuple) -> tuple:
    """A trained leaf's path in the trainable tree {"head", "lora"}."""
    return p[1:] if p[:2] == ("base", "head") else p


# ---------------------------------------------------------------------------
# the paper's parameter groups (Eq. 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Groups:
    """G = M fusion blocks + the shared B + one group per encoder layer
    and modality + one per head layer. Ids: the fusion blocks in modality
    order, then B, then the others as the trainable leaves are met in
    sorted key order; a tie in the divergence goes to the lower id."""
    names: list[str]
    modality: np.ndarray  # [G], -1 for none
    is_b: np.ndarray  # [G] bool
    is_block: np.ndarray  # [G] bool
    flops: np.ndarray  # [G] per-example forward FLOPs (the cost model)
    assign: dict  # trainable key -> ("rows", [D] ids) | ("axis0", [L]) | ("whole", g)

    @property
    def G(self) -> int:
        return len(self.names)


def groups(b: B2) -> Groups:
    names, mod = [], []
    rows = np.zeros(b.D, np.int64)
    off = 0
    for i, (name, _, dm, _) in enumerate(b.modalities):
        names.append(f"A_{name}")
        mod.append(i)
        rows[off:off + dm] = i
        off += dm
    names.append("B_shared")
    mod.append(-1)
    mindex = {m[0]: i for i, m in enumerate(b.modalities)}
    assign = {}
    keys = sorted([("head", "w1"), ("head", "w2")]
                  + [("lora", "encoders", m[0], "layers", t, ab)
                     for m in b.modalities for t in ("wi", "wq", "wv")
                     for ab in ("a", "b")]
                  + [("lora", "fusion", "a"), ("lora", "fusion", "b")])
    enc_ids: dict = {}
    for k in keys:
        if k == ("lora", "fusion", "a"):
            assign[k] = ("rows", rows)
        elif k == ("lora", "fusion", "b"):
            assign[k] = ("whole", b.M)
        elif k[0] == "head":
            names.append(f"H_{k[1]}")
            mod.append(-1)
            assign[k] = ("whole", len(names) - 1)
        else:
            ids = []
            for layer in range(b.enc_layers):
                kk = (k[2], layer)
                if kk not in enc_ids:
                    names.append(f"E_{k[2]}_L{layer}")
                    mod.append(mindex[k[2]])
                    enc_ids[kk] = len(names) - 1
                ids.append(enc_ids[kk])
            assign[k] = ("axis0", np.array(ids, np.int64))
    G = len(names)
    fl = np.zeros(G)
    ntok = b.window // b.patch
    for g, n in enumerate(names):
        if n.startswith("A_"):
            dm = next(m[2] for m in b.modalities if m[0] == n[2:])
            fl[g] = 2.0 * dm * b.lora_rank
        elif n == "B_shared":
            fl[g] = 2.0 * b.lora_rank * b.d_fused
        elif n.startswith("E_"):
            fl[g] = ntok * (4 * b.enc_d**2 + 2 * b.enc_d * b.enc_ff
                            + 2 * ntok * b.enc_d) * 2
        elif n == "H_w1":
            fl[g] = 2.0 * (b.d_fused * b.head_hidden)
        else:
            fl[g] = 2.0 * (b.head_hidden * b.n_classes)
    fl = np.maximum(fl, 1.0)
    modality = np.array(mod, np.int64)
    return Groups(names, modality, np.array([n == "B_shared" for n in names]),
                  np.array([n.startswith("A_") for n in names]), fl, assign)


def _gate_shape(kind, ids, leaf, W):
    """W [N, G] -> the factor for a client-stacked leaf [N, ...]."""
    if kind == "rows":
        return W[:, torch.as_tensor(ids, device=W.device)][:, :, None]
    if kind == "axis0":
        f = W[:, torch.as_tensor(ids, device=W.device)]
        return f.reshape(f.shape + (1,) * (leaf.dim() - 2))
    return W[:, ids].reshape((-1,) + (1,) * (leaf.dim() - 1))


def gate(gr: Groups, tree: dict, W: torch.Tensor) -> dict:
    return {k: v * _gate_shape(*gr.assign[k], v, W) for k, v in tree.items()}


def combine(gr: Groups, tree: dict, W: torch.Tensor) -> dict:
    """sum_n W[n, g] * leaf_n, per group slice -> leaves without N."""
    return {k: (v * _gate_shape(*gr.assign[k], v, W)).sum(0)
            for k, v in tree.items()}


def group_sq_norms(gr: Groups, tree: dict, N: int, device) -> torch.Tensor:
    """[N, G] squared Frobenius norms of each client's slices by group."""
    out = torch.zeros((N, gr.G), dtype=torch.float64, device=device)
    for k, v in tree.items():
        kind, ids = gr.assign[k]
        sq = v.double().square()
        if kind in ("rows", "axis0"):
            per = sq.sum(dim=tuple(range(2, sq.dim())))  # [N, D | L]
            out.index_add_(1, torch.as_tensor(ids, device=device), per)
        else:
            out[:, ids] += sq.sum(dim=tuple(range(1, sq.dim())))
    return out


# ---------------------------------------------------------------------------
# allocation (Eq. 7) -- host numpy, float64
# ---------------------------------------------------------------------------


def accessible(gr: Groups, mask: np.ndarray) -> np.ndarray:
    m = np.asarray(mask, bool)
    return np.stack([np.ones(len(m), bool) if gr.modality[g] < 0
                     else m[:, gr.modality[g]] for g in range(gr.G)], 1)


def mandatory(gr: Groups, mask: np.ndarray) -> np.ndarray:
    return accessible(gr, mask) & gr.is_block[None, :]


def budgets(gr: Groups, tops: np.ndarray, mask: np.ndarray, examples: int,
            utilization: float, t_overhead: float) -> np.ndarray:
    """k_n = clip(max(|M_n|, floor((T* - T_o) / tau_n)), 0, |G_n|), tau_n
    the mean group's training cost at the device's rate, T* the binary
    search's smallest target at which the fastest device trains its whole
    accessible set."""
    tau = (float(np.mean(gr.flops)) * examples * 4.0
           / (tops * 1e12 * utilization))
    n_mand = mandatory(gr, mask).sum(1)
    g_max = accessible(gr, mask).sum(1)

    def k_at(t):
        raw = np.floor((t - t_overhead) / np.maximum(tau, 1e-12)).astype(int)
        return np.clip(np.maximum(n_mand, raw), 0, g_max)

    floor = float(np.min(t_overhead + tau * g_max))
    lo, hi = floor, t_overhead + float(np.max(tau * g_max)) + 1.0
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        k = k_at(mid)
        ok = (np.max(np.minimum(t_overhead + tau * k,
                                t_overhead + tau * g_max)) <= mid + 1e-6
              or mid >= floor)
        if ok:
            hi = mid
        else:
            lo = mid
    return k_at(max(hi, floor))


def allocate(gr: Groups, dbar: np.ndarray, mask: np.ndarray,
             k: np.ndarray) -> np.ndarray:
    """Top-k by dbar among the accessible non-mandatory groups (ties to the
    lower id), after the mandatory ones -> S [N, G] bool."""
    cand = accessible(gr, mask) & ~mandatory(gr, mask)
    mand = mandatory(gr, mask)
    N = len(mask)
    S = mand.copy()
    for n in range(N):
        rest = max(int(k[n]) - int(mand[n].sum()), 0)
        c = np.nonzero(cand[n])[0]
        order = c[np.argsort(-np.asarray(dbar, np.float64)[c], kind="stable")]
        S[n, order[:rest]] = True
    return S


# ---------------------------------------------------------------------------
# the model, batched over clients
# ---------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to TF32 (10 mantissa bits, to nearest), straight through."""
    bits = x.detach().float().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


class Model:
    def __init__(self, b: B2, frozen: dict, emulate_tf32: bool = False):
        self.b, self.frozen = b, frozen
        self.rnd = _tf32 if emulate_tf32 else (lambda t: t)

    def mm(self, x, w):
        return self.rnd(x) @ self.rnd(w)

    def lora(self, x, a, b):
        """x [N, B, t, d]; a [N, d, r]; b [N, r, o] (per client)."""
        N = x.shape[0]
        u = self.mm(x.reshape(N, -1, x.shape[-1]), a)
        return (self.mm(u, b) * self.b.scale).reshape(x.shape[:-1] + (-1,))

    @staticmethod
    def rmsnorm(w, x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
            * (1.0 + w)

    def encoder(self, name, tr, x):
        b, fz = self.b, self.frozen
        N, B, T, C = x.shape
        ntok, H = T // b.patch, b.enc_heads
        hd = b.enc_d // H
        e = ("base", "encoders", name)
        lk = ("lora", "encoders", name, "layers")
        h = self.mm(x[:, :, :ntok * b.patch].reshape(N, B, ntok, b.patch * C),
                    fz[e + ("patch",)])
        for i in range(b.enc_layers):
            def w(*k, i=i):
                return fz[e + ("layers",) + k][i]

            def lo(t, i=i):
                return tr[lk + (t, "a")][:, i], tr[lk + (t, "b")][:, i]

            hn = self.rmsnorm(w("ln1"), h)
            q = self.mm(hn, w("attn", "wq")) + self.lora(hn, *lo("wq"))
            k = self.mm(hn, w("attn", "wk"))
            v = self.mm(hn, w("attn", "wv")) + self.lora(hn, *lo("wv"))
            q, k, v = (t.reshape(N, B, ntok, H, hd) for t in (q, k, v))
            s = torch.einsum("nbqhd,nbkhd->nbhqk", self.rnd(q),
                             self.rnd(k)) / math.sqrt(hd)
            o = torch.einsum("nbhqk,nbkhd->nbqhd",
                             self.rnd(torch.softmax(s, -1)), self.rnd(v))
            h = h + self.mm(o.reshape(N, B, ntok, H * hd), w("attn", "wo"))
            hn = self.rmsnorm(w("ln2"), h)
            up = self.mm(hn, w("mlp", "wi")) + self.lora(hn, *lo("wi"))
            h = h + self.mm(F.silu(self.mm(hn, w("mlp", "wg"))) * up,
                            w("mlp", "wo"))
        return self.mm(h.mean(2), fz[e + ("proj",)])

    def logits(self, tr, x, mmask):
        """tr: trainable {key: [N, ...]}; x [N, B, T, C]; mmask [N, M]."""
        b, fz = self.b, self.frozen
        hs, off = [], 0
        for i, (name, ch, dm, _) in enumerate(b.modalities):
            h = self.encoder(name, tr, x[..., off:off + ch])
            off += ch
            hs.append(h * mmask[:, None, i:i + 1])
        h = torch.cat(hs, -1)
        rows = torch.repeat_interleave(
            mmask, torch.as_tensor([m[2] for m in b.modalities],
                                   device=mmask.device), dim=1)
        hm = h * rows[:, None, :]
        u = self.mm(hm, tr[("lora", "fusion", "a")])
        z = self.mm(hm, fz[("base", "fusion_w0")]) \
            + self.mm(u, tr[("lora", "fusion", "b")]) * b.scale
        z = F.relu(self.mm(F.relu(z), tr[("head", "w1")]))
        return self.mm(z, tr[("head", "w2")])

    def losses(self, tr, x, y, mmask):
        """-> [N] mean cross-entropy of each client's batch."""
        lg = self.logits(tr, x, mmask)
        return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), y.reshape(-1),
                               reduction="none").reshape(y.shape).mean(1)


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoundRecord:
    loss: float  # mean over clients of each client's mean loss over steps
    S: np.ndarray  # [N, G] the allocation this round trained under
    dbar: np.ndarray  # [G] the EMA divergence after the round
    trainable: dict  # key -> global leaf after the round
    client_losses: np.ndarray  # [N] each client's mean loss over steps
    client_deltas: dict  # key -> [N, ...] each client's gated update


@contextlib.contextmanager
def _precision(precision: str, device: torch.device):
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32" and device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def run_rounds(b: B2, params: dict, data, fl, fed: dict, seed: int,
               rounds: int, device, precision: str = "fp32"
               ) -> list[RoundRecord]:
    """``rounds`` synchronous RELIEF rounds from ``params`` (flat {path:
    tensor}); ``fl``: inputs.Fleet; ``fed``: the traffic's round settings;
    batches drawn as the round draws them: one ``integers`` call per client
    in client order, from ``default_rng(seed)``."""
    device = torch.device(device)
    dt = torch.float64 if precision == "fp64" else torch.float32
    gr = groups(b)
    N = len(fl.tier)
    frozen = {k: v.to(device, dt) for k, v in params.items()
              if k[0] == "base" and k[:2] != ("base", "head")}
    glob = {trainable_key(p): params[p].to(device, dt)
            for p in trainable_paths(params)}
    model = Model(b, frozen, emulate_tf32=(precision == "tf32"
                                           and device.type != "cuda"))
    steps = fed["local_epochs"] * fed["steps_per_epoch"]
    Bsz, lr = fed["batch_size"], fed["lr"]
    k = budgets(gr, fl.tops, fl.modality_mask, steps * Bsz,
                fed["utilization"], fed["t_overhead"])
    acc = accessible(gr, fl.modality_mask)
    mmask = torch.as_tensor(fl.modality_mask, dtype=dt, device=device)
    mcount = mmask.sum(1)
    dbar = np.full(gr.G, 1e-6)
    rng = np.random.default_rng(seed)
    out = []
    with _precision(precision, device):
        for _ in range(rounds):
            S = allocate(gr, dbar, fl.modality_mask, k)
            xs, ys = [], []
            for n in range(N):
                src = n % len(data.train_y)
                idx = rng.integers(0, len(data.train_y[src]),
                                   size=(steps, Bsz))
                xs.append(data.train_x[src][idx])
                ys.append(data.train_y[src][idx])
            X = torch.as_tensor(np.stack(xs), device=device, dtype=dt)
            Y = torch.as_tensor(np.stack(ys), dtype=torch.int64,
                                device=device)
            gates = torch.as_tensor(S, dtype=dt, device=device)
            start = {kk: v.expand((N,) + v.shape).clone()
                     for kk, v in glob.items()}
            tr = {kk: v.clone().requires_grad_(True) for kk, v in start.items()}
            m = {kk: torch.zeros_like(v) for kk, v in start.items()}
            v2 = {kk: torch.zeros_like(v) for kk, v in start.items()}
            keys = sorted(tr)
            losses = []
            for s in range(steps):
                per = model.losses(tr, X[:, s], Y[:, s], mmask)
                grads = torch.autograd.grad(per.sum(), [tr[kk] for kk in keys])
                grads = gate(gr, dict(zip(keys, grads)), gates)
                t = s + 1
                bc1 = float(np.float32(1.0) - np.float32(0.9) ** np.float32(t))
                bc2 = float(np.float32(1.0) - np.float32(0.999) ** np.float32(t))
                with torch.no_grad():
                    for kk in keys:
                        g = grads[kk]
                        m[kk] = 0.9 * m[kk] + 0.1 * g
                        v2[kk] = 0.999 * v2[kk] + 0.001 * g.square()
                        step = lr * (m[kk] / bc1) / ((v2[kk] / bc2).sqrt()
                                                     + 1e-8)
                        tr[kk] = (tr[kk] - step).requires_grad_(True)
                losses.append(per.detach())
            with torch.no_grad():
                delta = gate(gr, {kk: tr[kk].detach() - start[kk]
                                  for kk in keys}, gates)
                w = gates * torch.where(
                    torch.as_tensor(gr.is_b, device=device)[None, :],
                    (mcount / b.M)[:, None], 1.0)
                den = w.sum(0, keepdim=True)
                W = torch.where(den > 0, w / den.clamp(min=1e-12), 0.0)
                agg = combine(gr, delta, W)
                glob = {kk: glob[kk] + fed["server_lr"] * agg[kk]
                        for kk in keys}
                c = torch.as_tensor(acc & S, dtype=dt, device=device)
                cnt = c.sum(0)
                Wm = torch.where(cnt[None, :] > 0,
                                 c / cnt.clamp(min=1.0)[None, :], 0.0)
                mean = combine(gr, delta, Wm)
                dev = {kk: delta[kk] - mean[kk][None] for kk in keys}
                per_client = group_sq_norms(gr, dev, N, device)
                d = torch.where(cnt.double() > 0,
                                (per_client * c.double()).sum(0)
                                / cnt.double().clamp(min=1.0), 0.0)
                dbar = fed["gamma"] * d.cpu().numpy() + (1 - fed["gamma"]) * dbar
            per_client = torch.stack(losses, 1).mean(1)
            out.append(RoundRecord(
                float(per_client.mean()), S, dbar.copy(),
                {kk: v.clone() for kk, v in glob.items()},
                per_client.double().cpu().numpy(), delta))
    return out
