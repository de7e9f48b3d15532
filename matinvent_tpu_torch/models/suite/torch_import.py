"""Reference torch checkpoints <-> the flax parameter tree of ``CSPNet``
(``matinvent_tpu/models/suite/torch_import.py``).

A reference state dict names the decoder's layers as the reference's
``nn.Sequential`` blocks (``csp_layer_<i>.edge_mlp.0`` / ``.2``,
``node_mlp.0`` / ``.2``) under ``decoder.``, and stores a linear layer's
weight ``[out, in]``; the flax tree stores ``kernel [in, out]`` and the
first edge layer as the flat leaves ``edge_mlp_0_kernel`` /
``edge_mlp_0_bias``. ``models/suite/mattergen.py:params_from_jax`` carries
that tree into the port's module.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _t(w) -> np.ndarray:
    return np.asarray(w, dtype=np.float32).T


def _a(w) -> np.ndarray:
    return np.asarray(w, dtype=np.float32)


def cspnet_params_from_state_dict(
    state_dict: Dict[str, Any], num_layers: int, prefix: str = "decoder.", ln: bool = False,
) -> dict:
    """A reference ``CSPNet`` state dict -> the flax tree ``{'params': ...}``."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}

    def dense(name):
        return {"kernel": _t(sd[f"{name}.weight"]), "bias": _a(sd[f"{name}.bias"])}

    params: dict = {
        "node_embedding": dense("node_embedding"),
        "atom_latent_emb": dense("atom_latent_emb"),
        "coord_out": {"kernel": _t(sd["coord_out.weight"])},
        "lattice_out": {"kernel": _t(sd["lattice_out.weight"])},
    }
    if "type_out.weight" in sd:
        params["type_out"] = dense("type_out")
    if ln and "final_layer_norm.weight" in sd:
        params["final_layer_norm"] = {
            "scale": _a(sd["final_layer_norm.weight"]),
            "bias": _a(sd["final_layer_norm.bias"]),
        }
    for i in range(num_layers):
        lp = f"csp_layer_{i}"
        layer = {
            "edge_mlp_0_kernel": _t(sd[f"{lp}.edge_mlp.0.weight"]),
            "edge_mlp_0_bias": _a(sd[f"{lp}.edge_mlp.0.bias"]),
            "edge_mlp_1": {"kernel": _t(sd[f"{lp}.edge_mlp.2.weight"]),
                           "bias": _a(sd[f"{lp}.edge_mlp.2.bias"])},
            "node_mlp_0": {"kernel": _t(sd[f"{lp}.node_mlp.0.weight"]),
                           "bias": _a(sd[f"{lp}.node_mlp.0.bias"])},
            "node_mlp_1": {"kernel": _t(sd[f"{lp}.node_mlp.2.weight"]),
                           "bias": _a(sd[f"{lp}.node_mlp.2.bias"])},
        }
        if ln and f"{lp}.layer_norm.weight" in sd:
            layer["layer_norm"] = {"scale": _a(sd[f"{lp}.layer_norm.weight"]),
                                   "bias": _a(sd[f"{lp}.layer_norm.bias"])}
        params[lp] = layer
    return {"params": params}


def cspnet_state_dict_from_params(params: dict, prefix: str = "decoder.") -> dict:
    """The flax tree ``{'params': ...}`` -> a reference state dict of numpy
    arrays (the inverse of ``cspnet_params_from_state_dict``)."""
    p = params["params"]
    sd: dict[str, np.ndarray] = {}

    def put_dense(name, node, bias=True):
        sd[f"{prefix}{name}.weight"] = np.asarray(node["kernel"]).T
        if bias and "bias" in node:
            sd[f"{prefix}{name}.bias"] = np.asarray(node["bias"])

    put_dense("node_embedding", p["node_embedding"])
    put_dense("atom_latent_emb", p["atom_latent_emb"])
    put_dense("coord_out", p["coord_out"], bias=False)
    put_dense("lattice_out", p["lattice_out"], bias=False)
    if "type_out" in p:
        put_dense("type_out", p["type_out"])
    if "final_layer_norm" in p:
        sd[f"{prefix}final_layer_norm.weight"] = np.asarray(p["final_layer_norm"]["scale"])
        sd[f"{prefix}final_layer_norm.bias"] = np.asarray(p["final_layer_norm"]["bias"])
    i = 0
    while f"csp_layer_{i}" in p:
        lp, q = p[f"csp_layer_{i}"], f"{prefix}csp_layer_{i}"
        sd[f"{q}.edge_mlp.0.weight"] = np.asarray(lp["edge_mlp_0_kernel"]).T
        sd[f"{q}.edge_mlp.0.bias"] = np.asarray(lp["edge_mlp_0_bias"])
        sd[f"{q}.edge_mlp.2.weight"] = np.asarray(lp["edge_mlp_1"]["kernel"]).T
        sd[f"{q}.edge_mlp.2.bias"] = np.asarray(lp["edge_mlp_1"]["bias"])
        sd[f"{q}.node_mlp.0.weight"] = np.asarray(lp["node_mlp_0"]["kernel"]).T
        sd[f"{q}.node_mlp.0.bias"] = np.asarray(lp["node_mlp_0"]["bias"])
        sd[f"{q}.node_mlp.2.weight"] = np.asarray(lp["node_mlp_1"]["kernel"]).T
        sd[f"{q}.node_mlp.2.bias"] = np.asarray(lp["node_mlp_1"]["bias"])
        if "layer_norm" in lp:
            sd[f"{q}.layer_norm.weight"] = np.asarray(lp["layer_norm"]["scale"])
            sd[f"{q}.layer_norm.bias"] = np.asarray(lp["layer_norm"]["bias"])
        i += 1
    return sd


def load_torch_checkpoint(path: str) -> dict:
    """The state dict of a torch ``.ckpt`` / ``.pth`` file, as numpy arrays
    (a Lightning checkpoint's ``state_dict``, else the file's dict)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
