"""MatterGen model suite, load path (``matinvent_tpu/models/suite/mattergen.py``).

A checkpoint directory holds ``config.yaml`` (one ``key: value`` line per
``MatterGenConfig`` field) and ``state_dict.npz`` (torch-layout weights
under ``decoder.``). The port builds ``MatterGenDiffusion`` from the first
and loads the second with ``load_state_dict(strict=True)``.

``params_from_jax`` turns the JAX package's flax parameter tree (as numpy)
into the same state dict, by the naming rules of
``matinvent_tpu/models/suite/mattergen_import.py:19-26``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
)
from matinvent_tpu_torch.utils.config import read_flat_yaml


def _torch_name(path: tuple[str, ...]) -> tuple[str, bool]:
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


def params_from_jax(params: Mapping[str, Any], prefix: str = "decoder.") -> dict[str, np.ndarray]:
    """Flax params (nested dicts of arrays, optionally under ``'params'``)
    -> a torch-layout state dict of float32 numpy arrays:
    ``kernel`` -> ``weight`` (transposed), ``scale``/``embedding`` ->
    ``weight``, ``X_kernel``/``X_bias`` -> ``X.weight`` (transposed) /
    ``X.bias``; other leaves keep their path."""
    if set(params) == {"params"}:
        params = params["params"]
    out: dict[str, np.ndarray] = {}

    def walk(node: Mapping[str, Any], path: tuple[str, ...]) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, (*path, k))
                continue
            name, transpose = _torch_name((*path, k))
            arr = np.asarray(v, dtype=np.float32)
            out[prefix + name] = np.ascontiguousarray(arr.T if transpose else arr)

    walk(params, ())
    return out


def load_config(model_path: str | Path, overrides: Mapping[str, Any] | None = None) -> MatterGenConfig:
    """``MatterGenConfig`` of a checkpoint directory; unknown keys dropped."""
    values = read_flat_yaml(Path(model_path) / "config.yaml")
    values.update(overrides or {})
    return MatterGenConfig.from_dict(values)


def load_model(
    model_path: str | Path,
    device: str | torch.device | None = None,
    config_overrides: Mapping[str, Any] | None = None,
) -> MatterGenDiffusion:
    """``MatterGenDiffusion`` with the checkpoint's weights, on ``device``
    (the card unless ``"cpu"`` is asked for)."""
    model = MatterGenDiffusion(load_config(model_path, config_overrides), device=device)
    with np.load(Path(model_path) / "state_dict.npz") as npz:
        sd = {k: torch.from_numpy(npz[k]) for k in npz.files}
    model.load_state_dict(sd, strict=True)
    return model.eval()
