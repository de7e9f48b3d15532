"""CSPNet and its layer (``matinvent_tpu/models/cspnet.py``).

The edges are a masked ``[B, A, A, ...]`` tensor: the dense fully
connected graph of each crystal (``edge_style`` fc, the mean over the
crystal's atoms), or its PBC radius and rank cutoff (knn,
``ops.neighbors.radius_knn_mask``, the mean over each atom's neighbours).
The first edge-MLP layer is applied decomposed:
its input ``concat(h_i, h_j, lattice_ip, dist_emb)`` splits the weight into
two ``[B, A, H]`` node terms, one ``[B, H]`` lattice term and the one true
edge product over the distance embedding. The parameter stays one
``edge_mlp_0`` linear layer, so the checkpoint's keys map 1:1.

``CSPNet`` is the JAX package's joint lattice/coord/type network with its
options: a relaxed one-hot (``smooth``) or an embedding of the atomic
number, layer norms, a scalar head (``pred_scalar``, the property
predictors), ``ip`` (True: the layers take the lattice inner products
``L L^T`` and the lattice head is multiplied by the lattice; False: the
layers take the raw lattice and the head is returned as it is) and
``use_dis_emb`` (True: the edge input is the Fourier embedding of the
coordinate differences, ``6 num_freqs`` lanes; False: the raw ``(x_j -
x_i) mod 1``, 3 lanes, which narrows ``edge_mlp_0``'s input). Neither
option reaches the fused edge kernel: ``CSPNet`` never runs it (the JAX
``CSPNet`` builds its layers without ``fused_edge``; DiffCSP's net is one),
and MatterGen's score net, which does, fixes ``ip=True`` and the Fourier
embedding (JAX ``score_net.py:164``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from matinvent_tpu_torch.ops.fused_edge import fused_edge_chain
from matinvent_tpu_torch.ops.neighbors import radius_knn_mask
from matinvent_tpu_torch.ops.segment import masked_mean

# flax.linen.LayerNorm's epsilon, which the checkpoints were trained with
LN_EPS = 1e-6


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of ``[..., 3, 3]`` cell matrices: the f64 product rounded
    to f32, as a broadcast multiply and sum. A matmul would go through
    cuBLAS, which rounds to TF32 where the process allows it; the JAX
    package pins these geometry products to ``Precision.HIGHEST``."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    return (a64[..., :, :, None] * b64[..., None, :, :]).sum(-2).to(torch.float32)


def edge_mask_and_denom(
    edge_style: str, frac_coords, lattice, num_atoms, mask, cutoff: float, max_neighbors: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(``[B, A, A]`` edge mask, ``[B, A]`` f32 aggregation denominator):
    fc edges and the crystal's atom count, or knn edges and each atom's
    neighbour count."""
    if edge_style == "knn":
        edge_mask = radius_knn_mask(frac_coords, lattice, mask, cutoff=cutoff,
                                    max_neighbors=max_neighbors)
        return edge_mask, edge_mask.sum(dim=-1).to(torch.float32)
    B, A = mask.shape
    return mask[:, :, None] & mask[:, None, :], num_atoms.to(torch.float32)[:, None].expand(B, A)


def sinusoids_embedding(x: torch.Tensor, n_frequencies: int = 10) -> torch.Tensor:
    """Fourier embedding of periodic offsets ``[..., S] -> [..., 2 S F]``:
    ``concat(sin(x (x) f), cos(x (x) f))`` with a space-major inner layout."""
    freqs = 2 * math.pi * torch.arange(n_frequencies, dtype=x.dtype, device=x.device)
    emb = x[..., None] * freqs  # [..., S, F]
    emb = emb.reshape(*x.shape[:-1], x.shape[-1] * n_frequencies)
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (a flax ``Dense(dtype=...)``: the
    parameters stay f32, inputs and parameters are cast for the product)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` as ``flax.linen.LayerNorm(dtype=dtype)`` computes it: the
    statistics in f32 (``E[x^2] - E[x]^2``, clipped at 0), the f32 scale and
    bias applied in f32, and one rounding to ``dtype`` at the end."""
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + layer.eps) * layer.weight.to(torch.float32)
    return ((x - mean) * mul + layer.bias.to(torch.float32)).to(dtype)


class CSPLayer(nn.Module):
    """One message-passing layer over the dense masked edge tensor."""

    def __init__(
        self, hidden_dim: int = 128, num_freqs: int = 10, ln: bool = False,
        use_dis_emb: bool = True,
    ):
        super().__init__()
        H = hidden_dim
        self.hidden_dim = H
        self.num_freqs = num_freqs
        self.use_dis_emb = use_dis_emb
        self.layer_norm = nn.LayerNorm(H, eps=LN_EPS) if ln else None
        dis_dim = 6 * num_freqs if use_dis_emb else 3
        self.edge_mlp_0 = nn.Linear(2 * H + 9 + dis_dim, H)
        self.edge_mlp_1 = nn.Linear(H, H)
        self.node_mlp_0 = nn.Linear(2 * H, H)
        self.node_mlp_1 = nn.Linear(H, H)

    def forward(
        self,
        node_features: torch.Tensor,  # [B, A, H]
        frac_diff: torch.Tensor | None,  # [B, A, A, 3] (x_j - x_i) mod 1
        lattice_ips: torch.Tensor,  # [B, 3, 3] lattice @ lattice.T (matmul3), or the lattice
        edge_mask: torch.Tensor,  # [B, A, A] bool: j is a neighbor of i
        denom: torch.Tensor,  # [B, A] aggregation denominator per node
        dist_emb: torch.Tensor | None = None,  # hoisted Fourier embedding
        frac_coords: torch.Tensor | None = None,  # [B, A, 3] (fused branch)
        mask: torch.Tensor | None = None,  # [B, A] atom mask (fused branch)
        *,
        fused_edge: bool = False,
        dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        H = self.hidden_dim
        node_input = node_features
        if self.layer_norm is not None:
            node_features = layer_norm(self.layer_norm, node_features, dtype)
        node_features = node_features.to(dtype)

        lattice_flat = lattice_ips.reshape(-1, 9).to(dtype)  # [B, 9]

        w = self.edge_mlp_0.weight.to(dtype)  # [H, 2H + 9 + 6nf] (out, in)
        b = self.edge_mlp_0.bias.to(dtype)
        w_i, w_j = w[:, :H], w[:, H : 2 * H]
        w_l, w_d = w[:, 2 * H : 2 * H + 9], w[:, 2 * H + 9 :]
        term_i = F.linear(node_features, w_i)  # [B, A, H], broadcast over j
        term_j = F.linear(node_features, w_j)  # [B, A, H], broadcast over i
        term_l = F.linear(lattice_flat, w_l)  # [B, H]
        if fused_edge:
            # the whole edge branch in one kernel: term_i absorbs the lattice
            # term and the bias; u_i folds the row mask and the mean
            m = mask.to(torch.float32)
            inv_denom = (m / torch.clamp(denom, min=1.0))[..., None]
            agg = fused_edge_chain(
                (term_i + (term_l + b)[:, None, :]).contiguous(),
                term_j.contiguous(),
                frac_coords.to(torch.float32).contiguous(),
                inv_denom.contiguous(),
                m[..., None].contiguous(),
                w_d.t().contiguous(),
                self.edge_mlp_1.weight.to(dtype).t().contiguous(),
                self.edge_mlp_1.bias.to(dtype).contiguous(),
                num_freqs=self.num_freqs,
            )
        else:
            if dist_emb is not None:
                dist = dist_emb.to(dtype)
            elif self.use_dis_emb:
                dist = sinusoids_embedding(frac_diff.to(torch.float32), self.num_freqs).to(dtype)
            else:
                dist = frac_diff.to(dtype)
            term_d = F.linear(dist, w_d)  # [B, A, A, H], the one edge product
            edge = (
                term_i[:, :, None, :]
                + term_j[:, None, :, :]
                + term_l[:, None, None, :]
                + term_d
                + b
            )
            edge = F.silu(edge)
            edge = F.silu(linear(self.edge_mlp_1, edge, dtype))
            # scatter-mean parity: for fc edges denom = num_atoms incl. the
            # self-loop
            edge = edge * edge_mask[..., None].to(edge.dtype)
            agg = torch.sum(edge, dim=2) / torch.clamp(denom, min=1.0).to(
                edge.dtype
            )[:, :, None]

        out = torch.cat([node_features, agg], dim=-1)
        out = F.silu(linear(self.node_mlp_0, out, dtype))
        out = F.silu(linear(self.node_mlp_1, out, dtype))
        return node_input + out.to(node_input.dtype)


class CSPNet(nn.Module):
    """Joint lattice/coord/type network over padded crystal batches, with
    the JAX package's parameter names (``node_embedding``,
    ``atom_latent_emb``, ``csp_layer_<i>``, ``final_layer_norm``,
    ``coord_out``, then ``scalar_out`` or ``lattice_out`` and
    ``type_out``). ``coord_out`` exists under the scalar head too, unused,
    as in the flax module, so checkpoints map 1:1."""

    def __init__(
        self,
        hidden_dim: int = 128,
        latent_dim: int = 256,
        num_layers: int = 4,
        max_atoms: int = 100,  # type vocabulary size
        num_freqs: int = 10,
        ln: bool = False,
        smooth: bool = True,
        pred_type: bool = True,
        pred_scalar: bool = False,
        edge_style: str = "fc",
        cutoff: float = 6.0,
        max_neighbors: int = 20,
        ip: bool = True,
        use_dis_emb: bool = True,
    ):
        super().__init__()
        if edge_style not in ("fc", "knn"):
            raise ValueError(f"unknown edge_style {edge_style}")
        self.edge_style, self.cutoff, self.max_neighbors = edge_style, cutoff, max_neighbors
        H = hidden_dim
        self.hidden_dim, self.latent_dim, self.num_layers = H, latent_dim, num_layers
        self.max_atoms, self.num_freqs = max_atoms, num_freqs
        self.smooth = smooth
        self.ip, self.use_dis_emb = ip, use_dis_emb
        self.pred_type, self.pred_scalar = pred_type, pred_scalar
        self.node_embedding = nn.Linear(max_atoms, H) if smooth else nn.Embedding(max_atoms, H)
        self.atom_latent_emb = nn.Linear(H + latent_dim, H)
        for i in range(num_layers):
            setattr(self, f"csp_layer_{i}", CSPLayer(H, num_freqs, ln=ln, use_dis_emb=use_dis_emb))
        self.final_layer_norm = nn.LayerNorm(H, eps=LN_EPS) if ln else None
        self.coord_out = nn.Linear(H, 3, bias=False)
        if pred_scalar:
            self.scalar_out = nn.Linear(H, 1)
        else:
            self.lattice_out = nn.Linear(H, 9, bias=False)
            if pred_type:
                self.type_out = nn.Linear(H, max_atoms)

    def forward(
        self,
        t_emb: torch.Tensor,  # [B, latent_dim]
        atom_feats: torch.Tensor,  # [B, A, K] probs (smooth) or [B, A] int types
        frac_coords: torch.Tensor,  # [B, A, 3]
        lattice: torch.Tensor,  # [B, 3, 3]
        num_atoms: torch.Tensor,  # [B]
        mask: torch.Tensor,  # [B, A] bool
        *,
        dtype: torch.dtype = torch.float32,
    ):
        """``[B, 1]`` under the scalar head, else ``(lattice_out [B,3,3],
        coord_out [B,A,3])`` and, with ``pred_type``, ``type_out [B,A,K]``."""
        if self.smooth:
            node = linear(self.node_embedding, atom_feats, dtype)
        else:
            # types - 1, a padded 0 wrapping to the last row as jnp.take does
            idx = (atom_feats.long() - 1) % self.max_atoms
            node = self.node_embedding.weight.to(dtype)[idx]
        B, A = node.shape[:2]
        t_per_atom = t_emb[:, None, :].expand(B, A, t_emb.shape[-1])
        node = linear(self.atom_latent_emb, torch.cat([node, t_per_atom.to(node.dtype)], -1), dtype)

        frac_diff = (frac_coords[:, None, :, :] - frac_coords[:, :, None, :]) % 1.0
        # hoisted once per eval and shared across layers
        dist_emb = (sinusoids_embedding(frac_diff.to(torch.float32), self.num_freqs).to(dtype)
                    if self.use_dis_emb else None)
        edge_mask, denom = edge_mask_and_denom(
            self.edge_style, frac_coords, lattice, num_atoms, mask,
            self.cutoff, self.max_neighbors,
        )
        # the layers' lattice term, once per eval
        lattice_ips = matmul3(lattice, lattice.transpose(-1, -2)) if self.ip else lattice
        for i in range(self.num_layers):
            node = getattr(self, f"csp_layer_{i}")(
                node, frac_diff, lattice_ips, edge_mask, denom, dist_emb=dist_emb, dtype=dtype,
            )
        if self.final_layer_norm is not None:
            node = layer_norm(self.final_layer_norm, node, dtype)

        graph_features = masked_mean(node, mask[..., None], axis=1)  # [B, H]
        if self.pred_scalar:
            # flax Dense without a dtype: the f32 parameters promote the input
            return F.linear(graph_features.to(torch.float32), self.scalar_out.weight,
                            self.scalar_out.bias)
        coord_out = linear(self.coord_out, node, dtype)
        lattice_out = linear(self.lattice_out, graph_features, dtype)
        lattice_out = lattice_out.reshape(-1, 3, 3).to(torch.float32)
        if self.ip:
            lattice_out = matmul3(lattice_out, lattice.to(torch.float32))
        if self.pred_type:
            type_out = linear(self.type_out, node, dtype)
            return lattice_out, coord_out.to(torch.float32), type_out.to(torch.float32)
        return lattice_out, coord_out.to(torch.float32)
