"""MatterGen-class checkpoints: a torch-style state dict <-> the flax
parameter tree (``matinvent_tpu/models/suite/mattergen_import.py``).

The reference saves RL checkpoints as a torch container ``{"state_dict":
..., "config": ...}`` (``last.ckpt``). The names follow torch's
conventions, by these rules from the flax tree:

  {...}.kernel      -> {...}.weight   (transposed: flax [in, out], torch [out, in])
  {...}.scale       -> {...}.weight   (LayerNorm)
  {...}.bias        -> {...}.bias
  {...}.embedding   -> {...}.weight   (no transpose)
  {...}X_kernel     -> {...}X.weight  (flat leaves, transposed)
  {...}X_bias       -> {...}X.bias
  anything else     -> its path       (the null-condition embeddings)

``mattergen_state_dict_from_params`` maps a flax tree to torch names and
``mattergen_params_from_state_dict`` maps them back, each the exact inverse
of the other. The map covers this framework's score network. The published
MatterGen checkpoints wrap a GemNet-style network of another architecture, whose
weights cannot be carried over: ``detect_gemnet`` recognizes them and
``mattergen_params_from_state_dict`` refuses them. Trees here are nested
dicts of numpy arrays.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

GEMNET_MARKERS = ("gemnet", "int_blocks", "out_blocks", "mlp_rbf", "atom_emb")


def detect_gemnet(state_dict: Mapping[str, Any]) -> bool:
    """True when a state dict belongs to the external GemNet-style MatterGen."""
    return any(any(m in k for m in GEMNET_MARKERS) for k in state_dict)


def leaf_name_and_transpose(path: tuple[str, ...]) -> tuple[str, bool]:
    """(torch name, transpose?) of one flax leaf path."""
    *parents, last = path
    if last == "kernel":
        return ".".join([*parents, "weight"]), True
    if last in ("scale", "embedding"):
        return ".".join([*parents, "weight"]), False
    if last == "bias":
        return ".".join([*parents, "bias"]), False
    if last.endswith("_kernel"):
        return ".".join([*parents, last[: -len("_kernel")], "weight"]), True
    if last.endswith("_bias"):
        return ".".join([*parents, last[: -len("_bias")], "bias"]), False
    return ".".join([*parents, last]), False


def mattergen_state_dict_from_params(
    params: Mapping[str, Any], prefix: str = "decoder."
) -> dict[str, np.ndarray]:
    """A flax parameter tree (nested dicts of arrays; a leading ``params``
    collection key is dropped from the paths) as a torch-style state dict
    of float32 numpy arrays, in JAX's leaf order (sorted keys)."""
    out: dict[str, np.ndarray] = {}

    def walk(node: Mapping[str, Any], path: tuple[str, ...]) -> None:
        for k in sorted(node):
            v = node[k]
            if isinstance(v, Mapping):
                walk(v, (*path, k))
                continue
            keys = (*path, k)
            name, transpose = leaf_name_and_transpose(keys[1:] if keys[0] == "params" else keys)
            arr = np.asarray(v, dtype=np.float32)
            out[prefix + name] = np.ascontiguousarray(arr.T if transpose else arr)

    walk(params, ())
    return out


def mattergen_params_from_state_dict(
    state_dict: Mapping[str, Any], template: Mapping[str, Any], prefix: str = "decoder."
) -> dict:
    """A flax parameter tree shaped as ``template`` (``{'params': ...}``),
    each leaf fetched from ``state_dict`` by its torch name. Raises
    ``ValueError`` on a GemNet checkpoint or a shape mismatch, ``KeyError``
    listing the names the state dict lacks."""
    if detect_gemnet(state_dict):
        raise ValueError(
            "this checkpoint contains a GemNet-style MatterGen network "
            "(external `mattergen` package weights). This framework's "
            "score network is a different architecture by design; weights "
            "cannot be mapped 1:1. Distill instead: "
            "`python -m matinvent_tpu_torch.tools.distill_mattergen "
            "teacher=<last.ckpt> corpus=<data.extxyz> out=<dir>` trains this "
            "network to match the torch model's per-field scores across the "
            "time grid."
        )
    missing: list[str] = []

    def build(node: Mapping[str, Any], path: tuple[str, ...]) -> dict:
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                out[k] = build(v, (*path, k))
                continue
            name, transpose = leaf_name_and_transpose((*path, k))
            full = prefix + name
            if full not in state_dict:
                missing.append(full)
                out[k] = v
                continue
            arr = np.asarray(state_dict[full], dtype=np.float32)
            if transpose:
                arr = arr.T
            if arr.shape != np.shape(v):
                raise ValueError(
                    f"{full}: checkpoint shape {arr.shape} != model shape "
                    f"{np.shape(v)}; model_cfg (hidden_dim/num_layers/"
                    f"condition_fields) must match the checkpoint's config"
                )
            out[k] = arr
        return out

    inner = template["params"] if set(template) == {"params"} else template
    params = build(inner, ())
    if missing:
        raise KeyError(f"{len(missing)} parameters missing from checkpoint, e.g. {missing[:5]}")
    return {"params": params}
