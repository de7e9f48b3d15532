"""MatterGen-class score network (``matinvent_tpu/models/mattergen/score_net.py``).

A dense masked message-passing network over padded crystal batches: D3PM
type classes in, a symmetrized per-graph cell score, per-atom frac-coord
scores and per-atom x0 type logits out. Parameter names equal the keys of the
checkpoints' ``state_dict.npz`` (under the ``decoder.`` prefix that
``MatterGenDiffusion`` adds).
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from matinvent_tpu_torch.models.cspnet import (
    LN_EPS,
    CSPLayer,
    layer_norm,
    linear,
    matmul3,
    sinusoids_embedding,
)
from matinvent_tpu_torch.ops.segment import masked_mean


class ConditionEmbedding(nn.Module):
    """Embed a dict of scalar conditions, with a learned null embedding per
    field (the classifier-free-guidance 'unconditional' token)."""

    def __init__(self, fields: tuple = (), dim: int = 128):
        super().__init__()
        self.fields = tuple(fields)
        self.dim = dim
        for f in self.fields:
            setattr(self, f"null_{f}", nn.Parameter(torch.zeros(dim)))
            setattr(self, f"embed_{f}_0", nn.Linear(1, dim))
            setattr(self, f"embed_{f}_1", nn.Linear(dim, dim))

    def forward(
        self,
        conditions: Mapping[str, torch.Tensor] | None,  # each [B]
        cond_mask: Mapping[str, torch.Tensor] | None = None,  # each [B] bool
        batch_size: int | None = None,
        device: torch.device | None = None,
    ) -> torch.Tensor:
        if not self.fields:
            return torch.zeros((batch_size, self.dim), device=device)
        conditions = conditions or {}
        outs = []
        for f in self.fields:
            null = getattr(self, f"null_{f}")
            if conditions.get(f) is not None:
                v = conditions[f].to(torch.float32)[:, None]
                emb = F.silu(getattr(self, f"embed_{f}_0")(v))
                emb = getattr(self, f"embed_{f}_1")(emb)
                if cond_mask is not None and f in cond_mask:
                    use = cond_mask[f][:, None].to(emb.dtype)
                    emb = use * emb + (1.0 - use) * null[None, :]
            else:
                b = batch_size if batch_size is not None else 1
                emb = null[None, :].expand(b, self.dim)
            outs.append(emb)
        return sum(outs)


class MatterGenScoreNet(nn.Module):
    """Joint (cell, frac-coord, type) denoiser over padded crystal batches."""

    def __init__(
        self,
        hidden_dim: int = 256,
        time_dim: int = 256,
        num_layers: int = 6,
        type_vocab: int = 100,
        num_freqs: int = 10,
        ln: bool = True,
        condition_fields: tuple = (),
        edge_style: str = "fc",
    ):
        super().__init__()
        if edge_style != "fc":
            # the knn edge style (ops/neighbors.py) is not ported yet
            raise NotImplementedError(f"edge_style {edge_style!r}: only 'fc' is ported")
        H = hidden_dim
        self.hidden_dim = H
        self.num_layers = num_layers
        self.num_freqs = num_freqs
        self.type_embedding = nn.Embedding(type_vocab, H)
        self.cond_emb = ConditionEmbedding(tuple(condition_fields), time_dim)
        self.atom_latent_emb = nn.Linear(H + time_dim, H)
        for i in range(num_layers):
            setattr(self, f"layer_{i}", CSPLayer(H, num_freqs, ln=ln))
        self.final_norm = nn.LayerNorm(H, eps=LN_EPS) if ln else None
        self.pos_out = nn.Linear(H, 3, bias=False)
        self.cell_out = nn.Linear(H, 9, bias=False)
        self.type_out = nn.Linear(H, type_vocab)

    def forward(
        self,
        t_emb: torch.Tensor,  # [B, time_dim]
        atom_types: torch.Tensor,  # [B, A] int (D3PM state, 0-based classes)
        frac_coords: torch.Tensor,  # [B, A, 3]
        lattice: torch.Tensor,  # [B, 3, 3]
        num_atoms: torch.Tensor,  # [B]
        mask: torch.Tensor,  # [B, A] bool
        conditions: Mapping[str, torch.Tensor] | None = None,
        cond_mask: Mapping[str, torch.Tensor] | None = None,
        *,
        fused_edge: bool = False,
        dtype: torch.dtype = torch.float32,
    ) -> dict[str, torch.Tensor]:
        """``fused_edge`` sends each layer's edge branch through
        ``ops.fused_edge.fused_edge_chain``; ``dtype`` is the activation
        dtype (parameters stay f32)."""
        B, A = atom_types.shape
        node = self.type_embedding.weight.to(dtype)[atom_types.long()]

        cond = self.cond_emb(conditions, cond_mask, batch_size=B, device=t_emb.device)
        latent = t_emb + cond
        lat_per_atom = latent[:, None, :].expand(B, A, latent.shape[-1])
        node = linear(
            self.atom_latent_emb, torch.cat([node, lat_per_atom.to(node.dtype)], dim=-1), dtype
        )

        edge_mask = mask[:, :, None] & mask[:, None, :]
        denom = num_atoms.to(torch.float32)[:, None].expand(B, A)
        if fused_edge:
            # the kernel recomputes frac_diff and the Fourier embedding
            frac_diff = dist_emb = None
        else:
            frac_diff = (frac_coords[:, None, :, :] - frac_coords[:, :, None, :]) % 1.0
            # hoisted once per eval and shared across layers
            dist_emb = sinusoids_embedding(
                frac_diff.to(torch.float32), self.num_freqs
            ).to(dtype)
        # the layers' lattice inner products (ip=True), also once per eval
        lattice_ips = matmul3(lattice, lattice.transpose(-1, -2))

        for i in range(self.num_layers):
            node = getattr(self, f"layer_{i}")(
                node, frac_diff, lattice_ips, edge_mask, denom, dist_emb=dist_emb,
                frac_coords=frac_coords, mask=mask, fused_edge=fused_edge,
                dtype=dtype,
            )

        if self.final_norm is not None:
            node = layer_norm(self.final_norm, node, dtype)

        pos_out = linear(self.pos_out, node, dtype).to(torch.float32)

        # per-graph symmetric cell score, right-coupled to the current cell
        # (f32 geometry)
        graph = masked_mean(node.to(torch.float32), mask[..., None], axis=1)
        cell_raw = F.linear(graph, self.cell_out.weight).reshape(-1, 3, 3)
        cell_sym = 0.5 * (cell_raw + cell_raw.transpose(-1, -2))
        cell_out = matmul3(cell_sym, lattice)

        type_out = linear(self.type_out, node, dtype).to(torch.float32)
        return {"cell": cell_out, "pos": pos_out, "atomic_numbers": type_out}
