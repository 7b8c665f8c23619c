"""MDLoRA group layout (paper Eq. 1, Sec. III-B): RELIEF's unified interface
for aggregation, elastic training and communication.

All trainable parameters are organized into G groups

    G = M fusion blocks + 1 shared B + sum_m L_m encoder groups + L_H head

A ``GroupLayout`` indexes every trainable leaf (or row range of the blocked
fusion leaf, or axis-0 slice of a layer-stacked leaf) to a group id and
carries per-group metadata. The blocked leaf is Backbone 1's ``fusion_w0``
or Backbone 2's fusion LoRA ``a``; Backbone 2's stacked encoder LoRA leaves
``[L, ...]`` give one group ``E_{m}_L{l}`` per layer. Leaves are walked in
sorted key order, as JAX flattens dicts, so group ids equal the
reference's: for PAMAP2 Backbone 1 the encoder groups come out acc, gyro,
hr, mag -- not modality order -- while the fusion rows stay in modality
order.

The tree ops take a gate or return norms with optional leading batch axes
(``[*B, G]``), so K client-stacked trees are gated in one call.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, map_with_path, path_str

__all__ = ["GroupLayout", "mm_group_layout", "group_gate_tree",
           "group_norms", "weighted_combine", "path_str", "KIND_FUSION_BLOCK", "KIND_FUSION_B",
           "KIND_ENCODER", "KIND_HEAD"]

KIND_FUSION_BLOCK = "fusion_block"
KIND_FUSION_B = "fusion_b"
KIND_ENCODER = "encoder"
KIND_HEAD = "head"


@dataclasses.dataclass
class GroupLayout:
    names: list[str]
    kinds: list[str]
    modality: np.ndarray  # [G] int, -1 for none
    sizes: np.ndarray  # [G] param counts
    flops: np.ndarray  # [G] relative per-round training cost
    leaf_group: dict[str, int]  # whole-leaf path -> group id
    # layer-stacked leaf -> per-slice gid (Backbone 2's encoder LoRA)
    leaf_axis0_groups: dict[str, np.ndarray]
    fusion_a_path: str | None  # the row-blocked leaf
    fusion_rows: list[tuple[int, int, int]]  # (row_start, row_end, group_id)
    n_modalities: int
    # (D, device) -> row_group_vector(D), (path, device) -> slice gids,
    # as tensors on that device
    _index: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def G(self) -> int:
        return len(self.names)

    def group_ids(self, kind: str) -> np.ndarray:
        return np.array([i for i, k in enumerate(self.kinds) if k == kind],
                        np.int32)

    def accessible(self, modality_mask: np.ndarray) -> np.ndarray:
        """modality_mask: [N, M] -> accessible groups G_n: [N, G] bool."""
        mm = np.asarray(modality_mask, bool)
        out = np.zeros((mm.shape[0], self.G), bool)
        for g in range(self.G):
            if self.sizes[g] == 0:  # empty group (e.g. no B matrix in B1)
                continue
            m = self.modality[g]
            out[:, g] = True if m < 0 else mm[:, m]
        return out

    def mandatory(self, modality_mask: np.ndarray) -> np.ndarray:
        """Mandatory inclusion {A_m : m in M_n} (paper IV-B2b): [N, G]."""
        mm = np.asarray(modality_mask, bool)
        out = np.zeros((mm.shape[0], self.G), bool)
        for g in range(self.G):
            if self.kinds[g] == KIND_FUSION_BLOCK:
                out[:, g] = mm[:, self.modality[g]]
        return out

    def rows_per_group(self, tree: Any) -> np.ndarray:
        """[G] rows along axis 0 (clients, for a stacked tree) of each
        group's leaves in ``tree``, 0 for a group it holds no leaf of; read
        from the shapes alone."""
        rows = np.zeros(self.G, np.int64)
        for p, leaf in leaves_with_path(tree):
            if p == self.fusion_a_path:
                gids = [g for _, _, g in self.fusion_rows]
            elif p in self.leaf_axis0_groups:
                gids = self.leaf_axis0_groups[p]
            elif p in self.leaf_group:
                gids = [self.leaf_group[p]]
            else:
                continue
            rows[gids] = np.maximum(rows[gids], leaf.shape[0])
        return rows

    def row_group_vector(self, D: int) -> np.ndarray:
        """[D] group id per row of the fusion leaf."""
        rg = np.zeros(D, np.int32)
        for s, e, g in self.fusion_rows:
            rg[s:e] = g
        return rg

    def row_index(self, D: int, device: torch.device) -> torch.Tensor:
        """``row_group_vector(D)`` as an int64 tensor on ``device``, built
        once per (D, device) so hot loops copy nothing to the card."""
        key = (D, str(device))
        if key not in self._index:
            self._index[key] = torch.as_tensor(
                self.row_group_vector(D), dtype=torch.int64, device=device)
        return self._index[key]

    def split_index(self, path: str, rows: int,
                    device: torch.device) -> torch.Tensor | None:
        """Group id of each axis-0 slice of a split leaf (the blocked
        fusion leaf's ``rows`` rows, or a stacked leaf's layers) as an int64
        tensor on ``device``; None for a whole-leaf group."""
        if path == self.fusion_a_path:
            return self.row_index(rows, device)
        if path not in self.leaf_axis0_groups:
            return None
        key = (path, str(device))
        if key not in self._index:
            self._index[key] = torch.as_tensor(
                self.leaf_axis0_groups[path], dtype=torch.int64,
                device=device)
        return self._index[key]


def mm_group_layout(cfg, trainable: dict) -> GroupLayout:
    """Build the paper's G-group layout from an MMConfig + a trainable
    subtree (full params for Backbone 1; {lora, head} for Backbone 2)."""
    names: list[str] = []
    kinds: list[str] = []
    modality: list[int] = []
    sizes: list[int] = []
    leaf_group: dict[str, int] = {}
    leaf_axis0_groups: dict[str, np.ndarray] = {}
    fusion_rows: list[tuple[int, int, int]] = []
    fusion_a_path: str | None = None

    def new_group(name, kind, mod):
        names.append(name)
        kinds.append(kind)
        modality.append(mod)
        sizes.append(0)
        return len(names) - 1

    # fusion blocks first (stable ids 0..M-1), then B
    off = 0
    for i, m in enumerate(cfg.modalities):
        g = new_group(f"A_{m.name}", KIND_FUSION_BLOCK, i)
        fusion_rows.append((off, off + m.d_feat, g))
        off += m.d_feat
    b_gid = new_group("B_shared", KIND_FUSION_B, -1)

    mod_index = {m.name: i for i, m in enumerate(cfg.modalities)}
    enc_groups: dict[tuple[int, str], int] = {}
    head_groups: dict[str, int] = {}

    for p, leaf in leaves_with_path(trainable):
        is_fusion = "fusion" in p
        if (is_fusion and p.endswith("['a']")) or "fusion_w0" in p:
            # Backbone 2's fusion LoRA a, or Backbone 1's FC weight itself
            fusion_a_path = p
            dout = leaf.shape[1]
            for s, e, g in fusion_rows:
                sizes[g] += (e - s) * dout
            continue
        if is_fusion and p.endswith("['b']"):
            leaf_group[p] = b_gid
            sizes[b_gid] += leaf.numel()
            continue
        enc_mod = next((mod_index[nm] for nm in mod_index
                        if f"['{nm}']" in p), None)
        if enc_mod is not None:
            mname = cfg.modalities[enc_mod].name
            if "layers" in p:  # layer-stacked leaf: one group per layer
                n_l = leaf.shape[0]
                gids = []
                for layer in range(n_l):
                    kk = (enc_mod, f"L{layer}")
                    if kk not in enc_groups:
                        enc_groups[kk] = new_group(f"E_{mname}_L{layer}",
                                                   KIND_ENCODER, enc_mod)
                    gids.append(enc_groups[kk])
                    sizes[enc_groups[kk]] += leaf.numel() // n_l
                leaf_axis0_groups[p] = np.array(gids, np.int32)
                continue
            # per-module leaf (conv1/conv2/proj)
            toks = re.findall(r"\['(\w+)'\]", p)
            label = toks[min(toks.index(mname) + 1, len(toks) - 1)]
            kk = (enc_mod, label)
            if kk not in enc_groups:
                enc_groups[kk] = new_group(f"E_{mname}_{label}",
                                           KIND_ENCODER, enc_mod)
            leaf_group[p] = enc_groups[kk]
            sizes[enc_groups[kk]] += leaf.numel()
            continue
        # head (and any remaining global leaf): one group per head layer
        label = re.findall(r"\['(\w+)'\]", p)[-1]
        if label not in head_groups:
            head_groups[label] = new_group(f"H_{label}", KIND_HEAD, -1)
        leaf_group[p] = head_groups[label]
        sizes[head_groups[label]] += leaf.numel()

    sizes_np = np.array(sizes, np.int64)
    flops = np.maximum(sizes_np.astype(np.float64), 1.0)
    return GroupLayout(names, kinds, np.array(modality, np.int32), sizes_np,
                       flops, leaf_group, leaf_axis0_groups, fusion_a_path,
                       fusion_rows, cfg.M)


def group_gate_tree(layout: GroupLayout, tree: Any,
                    gate: torch.Tensor) -> Any:
    """gate: [*B, G] -> tree with per-group gates applied (fusion rows and
    stacked-layer slices get their group's gate); leaves carry the same
    leading ``*B`` axes. Used to mask gradients (elastic training) and
    uploads (Eq. 8). A leaf the layout does not place is zeroed."""
    nb = gate.dim() - 1

    def gate_leaf(p, leaf):
        idx = layout.split_index(p, leaf.shape[nb], leaf.device)
        if idx is not None:
            g = gate[..., idx].to(leaf.dtype)  # [*B, D] or [*B, L]
            return leaf * g.reshape(g.shape + (1,) * (leaf.dim() - nb - 1))
        if p in layout.leaf_group:
            g = gate[..., layout.leaf_group[p]].to(leaf.dtype)  # [*B]
            return leaf * g.reshape(g.shape + (1,) * (leaf.dim() - nb))
        return leaf * 0

    return map_with_path(gate_leaf, tree)


def group_norms(layout: GroupLayout, tree: Any,
                batch_dims: int = 0) -> torch.Tensor:
    """Per-group squared Frobenius norms -> [*B, G] float32, where the
    leaves carry ``batch_dims`` leading axes ``*B``.

    No atomics, so a call gives the same bits every time on the card too
    (selective upload ranks blocks by these norms; a near-tie must not pick
    another block from one call to the next). A split leaf's rows of one
    group are added one after another in row order, as the CPU's
    ``index_add`` adds them: ``_segments`` lays them out in columns."""
    acc = None
    for p, leaf in leaves_with_path(tree):
        x32 = leaf.float()
        if acc is None:
            acc = torch.zeros(x32.shape[:batch_dims] + (layout.G,),
                              dtype=torch.float32, device=x32.device)
        idx = layout.split_index(p, leaf.shape[batch_dims], leaf.device)
        if idx is not None:
            per_row = x32.square().sum(
                dim=tuple(range(batch_dims + 1, x32.dim())))  # [*B, D|L]
            cols, gids = _segments(layout, p, per_row.shape[-1], leaf.device)
            padded = torch.cat([per_row, per_row.new_zeros(
                per_row.shape[:-1] + (1,))], -1)[..., cols]  # [*B, R, S]
            seg = torch.zeros_like(padded[..., 0, :])
            for j in range(padded.shape[-2]):
                seg = seg + padded[..., j, :]
            acc[..., gids] += seg  # one term per group: no two adds meet
        elif p in layout.leaf_group:
            s = x32.square().sum(dim=tuple(range(batch_dims, x32.dim())))
            acc[..., layout.leaf_group[p]] += s
    return acc


def _segments(layout: GroupLayout, path: str, rows: int,
              device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A split leaf's rows by group: ``cols`` [R, S] holds, in column s,
    the rows of group ``gids[s]`` in order, padded with ``rows`` (an index
    past the last row, a zero) to the longest group's R rows."""
    key = ("segments", path, rows, str(device))
    if key not in layout._index:
        g = layout.split_index(path, rows, "cpu").numpy()
        gids = np.unique(g)
        members = [np.nonzero(g == k)[0] for k in gids]
        R = max(len(m) for m in members)
        cols = np.full((R, len(gids)), rows, np.int64)
        for s, m in enumerate(members):
            cols[:len(m), s] = m
        layout._index[key] = (torch.as_tensor(cols, device=device),
                              torch.as_tensor(gids, dtype=torch.int64,
                                              device=device))
    return layout._index[key]


def weighted_combine(layout: GroupLayout, deltas: Any,
                     W: torch.Tensor) -> Any:
    """Aggregate client-stacked deltas with per-(client, group) weights.

    deltas: tree with a leading client axis N on every leaf; W: [N, G]
    combine weights (rows need not sum to 1; the caller normalizes).
    -> tree without the client axis: sum_n W[n, g_leaf] * delta_n, in fp32.
    """
    W = W.float()

    def combine(p, leaf):
        x = leaf.float()
        idx = layout.split_index(p, leaf.shape[1], leaf.device)
        if idx is not None:
            n, rows = x.shape[:2]
            out = torch.einsum("nd,ndr->dr", W[:, idx], x.reshape(n, rows, -1))
            return out.reshape(x.shape[1:])
        if p in layout.leaf_group:
            return torch.einsum("n,n...->...", W[:, layout.leaf_group[p]], x)
        return torch.zeros(leaf.shape[1:], device=leaf.device)

    return map_with_path(combine, deltas)
