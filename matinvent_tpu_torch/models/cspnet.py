"""CSPNet building blocks (``matinvent_tpu/models/cspnet.py``).

The edges are the dense fully connected graph of each crystal, a masked
``[B, A, A, ...]`` tensor. The first edge-MLP layer is applied decomposed:
its input ``concat(h_i, h_j, lattice_ip, dist_emb)`` splits the weight into
two ``[B, A, H]`` node terms, one ``[B, H]`` lattice term and the one true
edge product over the distance embedding. The parameter stays one
``edge_mlp_0`` linear layer, so the checkpoint's keys map 1:1.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from matinvent_tpu_torch.ops.fused_edge import fused_edge_chain

# flax.linen.LayerNorm's epsilon, which the checkpoints were trained with
LN_EPS = 1e-6


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of ``[..., 3, 3]`` cell matrices: the f64 product rounded
    to f32, as a broadcast multiply and sum. A matmul would go through
    cuBLAS, which rounds to TF32 where the process allows it; the JAX
    package pins these geometry products to ``Precision.HIGHEST``."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    return (a64[..., :, :, None] * b64[..., None, :, :]).sum(-2).to(torch.float32)


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
    ):
        super().__init__()
        H = hidden_dim
        self.hidden_dim = H
        self.num_freqs = num_freqs
        self.layer_norm = nn.LayerNorm(H, eps=LN_EPS) if ln else None
        self.edge_mlp_0 = nn.Linear(2 * H + 9 + 6 * num_freqs, H)
        self.edge_mlp_1 = nn.Linear(H, H)
        self.node_mlp_0 = nn.Linear(2 * H, H)
        self.node_mlp_1 = nn.Linear(H, H)

    def forward(
        self,
        node_features: torch.Tensor,  # [B, A, H]
        frac_diff: torch.Tensor | None,  # [B, A, A, 3] (x_j - x_i) mod 1
        lattice_ips: torch.Tensor,  # [B, 3, 3] lattice @ lattice.T (matmul3)
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
            dist = (
                dist_emb.to(dtype) if dist_emb is not None
                else sinusoids_embedding(frac_diff.to(torch.float32), self.num_freqs).to(dtype)
            )
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
