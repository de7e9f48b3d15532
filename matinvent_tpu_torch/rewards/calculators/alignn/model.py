"""The ALIGNN forward in PyTorch over a torch ``state_dict``
(``matinvent_tpu/rewards/calculators/alignn/model.py``).

The published ALIGNN / ALIGNNAtomWise architecture (usnistgov alignn), so
that published checkpoints load as they are: the parameters are the
``state_dict`` under its published names
(``alignn_layers.0.node_update.src_gate.weight``, ...), on the forward's
device. The equations (npj Comput. Mater. 7, 185 (2021)):

* ``MLPLayer``: Linear, then BatchNorm1d in eval mode (running statistics)
  or LayerNorm, then SiLU (the norm read from the state dict,
  ``detect_norm_kind``);
* ``EdgeGatedGraphConv``, residual:
      m_e   = src_gate(x_u) + dst_gate(x_v) + edge_gate(y_e)
      sigma = logistic(m_e)
      h_v   = sum_{e=(u->v)} sigma_e * dst_update(x_u) / (sum sigma_e + 1e-6)
      x'    = x + SiLU(norm(src_update(x) + h))
      y'    = y + SiLU(norm(m))
  (the sums are ``index_add_`` over the padded edge list, padded edges
  masked out);
* ``ALIGNNConv``: that convolution on the atom graph (x, y), then on the
  line graph (y, z);
* ``RBFExpansion`` with the reference code's gamma = 1 / mean(diff(centers))
  (not 1 / lengthscale^2);
* an average-pool readout over the real atoms, ``fc``, and the link:
  identity, exp (``log``), logistic (``logit``), or log-softmax for
  classification.

Precision: JAX pins ``Precision.HIGHEST`` on every matmul, as this is a
reward whose claim is fidelity to the checkpoint. The port computes every
matmul in full f32 with TF32 off: ``alignn_forward`` turns TF32 off for
its own duration (``full_f32``) whatever the caller set, and restores it.
There is no custom kernel here: no function of the JAX ALIGNN reaches a
Pallas kernel.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from matinvent_tpu_torch.rewards.calculators.alignn.graphs import ALIGNNBatch


@dataclass(frozen=True)
class ALIGNNSpec:
    """The ``config["model"]`` fields that shape the forward pass."""

    alignn_layers: int = 4
    gcn_layers: int = 4
    atom_input_features: int = 92
    edge_input_features: int = 80
    triplet_input_features: int = 40
    embedding_features: int = 64
    hidden_features: int = 256
    output_features: int = 1
    link: str = "identity"
    classification: bool = False
    norm_kind: str = "batchnorm"  # "batchnorm" | "layernorm" (from the state dict)

    @classmethod
    def from_model_config(cls, cfg: dict, norm_kind: str) -> "ALIGNNSpec":
        known = {
            k: cfg[k]
            for k in (
                "alignn_layers", "gcn_layers", "atom_input_features",
                "edge_input_features", "triplet_input_features",
                "embedding_features", "hidden_features", "output_features",
                "link", "classification",
            )
            if k in cfg
        }
        return cls(norm_kind=norm_kind, **known)


def detect_norm_kind(state_dict) -> str:
    return "batchnorm" if any(k.endswith("running_mean") for k in state_dict) else "layernorm"


@contextmanager
def full_f32():
    """TF32 off for CUDA matmuls while active (the JAX forward's HIGHEST)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _linear(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _norm(p, name, x, kind):
    if kind == "batchnorm":  # eval mode: running statistics
        inv = torch.rsqrt(p[f"{name}.running_var"] + 1e-5)
        return (x - p[f"{name}.running_mean"]) * inv * p[f"{name}.weight"] + p[f"{name}.bias"]
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p[f"{name}.weight"] + p[f"{name}.bias"]


def _mlp_layer(p, name, x, kind):
    """MLPLayer: Linear, norm, SiLU (keys ``<name>.layer.{0,1}``)."""
    return F.silu(_norm(p, f"{name}.layer.1", _linear(p, f"{name}.layer.0", x), kind))


def _rbf(p, name, x, vmin, vmax, bins):
    centers = p.get(f"{name}.centers")
    if centers is None:  # older checkpoints without the registered buffer
        centers = torch.linspace(vmin, vmax, bins, device=x.device)
    gamma = 1.0 / ((vmax - vmin) / (bins - 1))  # the reference code's quirk
    return torch.exp(-gamma * (x[:, None] - centers[None, :]) ** 2)


def _segment_sum(values, index, num):
    return torch.zeros((num, *values.shape[1:]), dtype=values.dtype,
                       device=values.device).index_add_(0, index, values)


def _edge_gated_conv(p, name, x, y, src, dst, edge_mask, kind):
    """One EdgeGatedGraphConv step on a flat padded edge list."""
    m = (
        _linear(p, f"{name}.src_gate", x)[src]
        + _linear(p, f"{name}.dst_gate", x)[dst]
        + _linear(p, f"{name}.edge_gate", y)
    )
    sigma = torch.sigmoid(m) * edge_mask[:, None]
    bh = _linear(p, f"{name}.dst_update", x)[src]
    num = x.shape[0]
    h = _segment_sum(sigma * bh, dst, num) / (_segment_sum(sigma, dst, num) + 1e-6)
    x_new = x + F.silu(_norm(p, f"{name}.bn_nodes", _linear(p, f"{name}.src_update", x) + h, kind))
    y_new = y + F.silu(_norm(p, f"{name}.bn_edges", m, kind))
    return x_new, y_new


@torch.no_grad()
def alignn_forward(params: dict, spec: ALIGNNSpec, atom_table: torch.Tensor,
                   batch: dict, num_graphs: int) -> torch.Tensor:
    """``[num_graphs]`` predictions (``[num_graphs, K]`` for several
    outputs) of a batch of device tensors (``batch_tensors``)."""
    kind = spec.norm_kind
    with full_f32():
        x = _mlp_layer(params, "atom_embedding", atom_table[batch["species"]], kind)
        y = _rbf(params, "edge_embedding.0", batch["edge_len"], 0.0, 8.0, spec.edge_input_features)
        y = _mlp_layer(params, "edge_embedding.1", y, kind)
        y = _mlp_layer(params, "edge_embedding.2", y, kind)
        if spec.alignn_layers > 0:
            z = _rbf(params, "angle_embedding.0", batch["trip_cos"], -1.0, 1.0,
                     spec.triplet_input_features)
            z = _mlp_layer(params, "angle_embedding.1", z, kind)
            z = _mlp_layer(params, "angle_embedding.2", z, kind)
        edges = (batch["edge_src"], batch["edge_dst"], batch["edge_mask"])
        for i in range(spec.alignn_layers):
            x, y = _edge_gated_conv(params, f"alignn_layers.{i}.node_update", x, y, *edges, kind)
            # the line graph: its nodes are the directed bonds (y), its
            # edges the triplets
            y, z = _edge_gated_conv(params, f"alignn_layers.{i}.edge_update", y, z,
                                    batch["trip_a"], batch["trip_b"], batch["trip_mask"], kind)
        for i in range(spec.gcn_layers):
            x, y = _edge_gated_conv(params, f"gcn_layers.{i}", x, y, *edges, kind)

        # average pooling over each graph's real atoms
        w = batch["node_mask"][:, None].to(x.dtype)
        num = _segment_sum(x * w, batch["node_graph"], num_graphs)
        den = _segment_sum(w, batch["node_graph"], num_graphs)
        out = _linear(params, "fc", num / torch.clamp(den, min=1.0))
    if spec.classification:
        out = torch.log_softmax(out, dim=-1)
    elif spec.link == "log":
        out = torch.exp(out)
    elif spec.link == "logit":
        out = torch.sigmoid(out)
    return out[:, 0] if out.shape[-1] == 1 else out


def batch_tensors(batch: ALIGNNBatch, device) -> dict:
    """The host batch's arrays as tensors on ``device`` (indices int64,
    lengths and cosines f32, masks f32)."""
    dev = torch.device(device)
    out = {}
    for k in ("species", "node_graph", "edge_src", "edge_dst", "trip_a", "trip_b"):
        out[k] = torch.as_tensor(getattr(batch, k), dtype=torch.long).to(dev)
    for k in ("edge_len", "trip_cos", "node_mask", "edge_mask", "trip_mask"):
        out[k] = torch.as_tensor(np.asarray(getattr(batch, k), np.float32)).to(dev)
    return out


def run_batch(params: dict, spec: ALIGNNSpec, atom_table: torch.Tensor,
              batch: ALIGNNBatch) -> np.ndarray:
    """Forward a host-built ``ALIGNNBatch`` on the parameters' device;
    returns ``[num_graphs]`` predictions."""
    dev = atom_table.device
    out = alignn_forward(params, spec, atom_table, batch_tensors(batch, dev), batch.num_graphs)
    return out.cpu().numpy().astype(float)
