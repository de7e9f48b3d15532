"""MatterGen model suite (``matinvent_tpu/models/suite/mattergen.py``).

A checkpoint directory holds ``config.yaml`` (one ``key: value`` line per
``MatterGenConfig`` field) and ``state_dict.npz`` (torch-layout weights
under ``decoder.``). The port builds ``MatterGenDiffusion`` from the first
and loads the second with ``load_state_dict(strict=True)``; ``save_model``
writes both and ``params.msgpack``, the flax tree of the JAX package's
``MatterGenDiffusion`` in flax's serialization (``utils/msgpack.py``), which
is what the JAX suite loads.

``params_from_jax`` turns the JAX package's flax parameter tree (as numpy)
into the same state dict, by the naming rules of
``matinvent_tpu/models/suite/mattergen_import.py:19-26``, and
``params_to_jax`` turns it back.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
)
from matinvent_tpu_torch.models.mattergen.sample import MatterGenSampler
from matinvent_tpu_torch.models.suite.base import ModelSuite
from matinvent_tpu_torch.parallel.train import FinetuneStep
from matinvent_tpu_torch.utils import msgpack
from matinvent_tpu_torch.utils.config import read_flat_yaml, write_flat_yaml

# condition fields per pretrained variant
AVA_MODEL_NAMES = {
    "mattergen_base": (),
    "mattergen_chemical_system": ("chemical_system",),
    "mattergen_space_group": ("space_group",),
    "mattergen_dft_mag_density": ("dft_mag_density",),
    "mattergen_dft_band_gap": ("dft_band_gap",),
    "mattergen_ml_bulk_modulus": ("ml_bulk_modulus",),
    "mattergen_dft_mag_density_hhi_score": ("dft_mag_density", "hhi_score"),
    "mattergen_chemical_system_energy_above_hull": (
        "chemical_system",
        "energy_above_hull",
    ),
}

# linear layers whose flax params are flat ``<name>_kernel``/``<name>_bias``
# leaves of their parent module
_FLAT_LEAVES = ("edge_mlp_0",)


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


def _flax_path(name: str, module: nn.Module) -> tuple[tuple[str, ...], bool]:
    """(flax leaf path, transpose?) of one parameter of ``module`` (the
    score net), by the type of the submodule that holds it."""
    *parents, leaf = name.split(".")
    owner = module.get_submodule(".".join(parents)) if parents else module
    if isinstance(owner, nn.Linear):
        if parents[-1] in _FLAT_LEAVES:
            flat = f"{parents[-1]}_{'kernel' if leaf == 'weight' else 'bias'}"
            return (*parents[:-1], flat), leaf == "weight"
        return (*parents, "kernel" if leaf == "weight" else "bias"), leaf == "weight"
    if isinstance(owner, nn.LayerNorm):
        return (*parents, "scale" if leaf == "weight" else "bias"), False
    if isinstance(owner, nn.Embedding):
        return (*parents, "embedding"), False
    return (*parents, leaf), False


def params_to_jax(
    state_dict: Mapping[str, Any], model: nn.Module, prefix: str = "decoder."
) -> dict[str, Any]:
    """The reverse of ``params_from_jax``: a state dict of ``model`` -> the
    JAX package's ``{'params': ...}`` tree of float32 numpy arrays. The
    flax tree is that of ``model``'s submodule at ``prefix`` (the score net
    of a ``MatterGenDiffusion``; ``model`` itself for ``prefix=""``)."""
    net = model.get_submodule(prefix.rstrip(".")) if prefix else model
    tree: dict[str, Any] = {}
    for key, value in state_dict.items():
        if not key.startswith(prefix):
            raise KeyError(f"{key} is not under {prefix!r}")
        path, transpose = _flax_path(key[len(prefix):], net)
        arr = np.asarray(value.detach().cpu() if torch.is_tensor(value) else value, np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr.T if transpose else arr)
    return {"params": tree}


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


def save_model(model: MatterGenDiffusion, save_dir: str | Path) -> None:
    """``params.msgpack``, ``state_dict.npz`` and ``config.yaml`` of
    ``model`` in ``save_dir``, as the JAX package writes them
    (``config.yaml`` also carries the JAX config's ``fused_edge_sampling:
    false``, which the port ignores)."""
    os.makedirs(save_dir, exist_ok=True)
    sd = {k: v.detach().cpu().numpy() for k, v in sorted(model.state_dict().items())}
    with open(os.path.join(save_dir, "params.msgpack"), "wb") as fh:
        fh.write(msgpack.packb(params_to_jax(sd, model)))
    np.savez(os.path.join(save_dir, "state_dict.npz"), **sd)
    cfg = {f: getattr(model.config, f) for f in MatterGenConfig.__dataclass_fields__}
    cfg["fused_edge_sampling"] = False
    write_flat_yaml(os.path.join(save_dir, "config.yaml"), cfg)


class MatterGenSuite(ModelSuite):
    """Model facade of the RL loop: builds the diffusion module, loads or
    initializes its weights, and hands out a sampler and a fine-tune
    driver. A checkpoint's ``config.yaml`` is authoritative over
    ``model_cfg``; only ``config_overrides`` apply on top of it."""

    def __init__(
        self,
        model_name: str = "mattergen_base",
        sample_cfg: dict | None = None,
        finetune_cfg: dict | None = None,
        model_path: str | None = None,
        model_cfg: dict | None = None,
        config_overrides: dict | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        if model_name not in AVA_MODEL_NAMES:
            raise ValueError(
                f"unknown MatterGen variant {model_name}; available: {sorted(AVA_MODEL_NAMES)}"
            )
        super().__init__(model_name, sample_cfg, finetune_cfg, model_path,
                         config_overrides, seed, device)
        values = self.resolve_model_config(model_cfg)
        values.setdefault("condition_fields", AVA_MODEL_NAMES[model_name])
        self.model_config = MatterGenConfig.from_dict(values)

    def load_model(self) -> MatterGenDiffusion:
        """A new module with the checkpoint's weights, or, without a
        ``model_path``, weights initialized from ``seed``."""
        if self.model_path is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self.seed)
                return MatterGenDiffusion(self.model_config, device=self.device).eval()
        model = MatterGenDiffusion(self.model_config, device=self.device)
        with np.load(Path(self.model_path) / "state_dict.npz") as npz:
            sd = {k: torch.from_numpy(npz[k]) for k in npz.files}
        model.load_state_dict(sd, strict=True)
        return model.eval()

    def get_sampler(self) -> MatterGenSampler:
        s = self.sample_cfg
        if s.get("target_compositions_dict"):
            raise NotImplementedError("sample_cfg 'target_compositions_dict' is not ported")
        return MatterGenSampler(
            batch_size=s.get("batch_size"),
            num_batches=s.get("num_batches"),
            num_atoms_distribution=s.get("num_atoms_distribution", "mp_20"),
            num_atoms_distribution_file=s.get("num_atoms_distribution_file"),
            max_atoms=s.get("max_atoms", 20),
            diffusion_guidance_factor=s.get("diffusion_guidance_factor", 0.0),
            properties_to_condition_on=s.get("properties_to_condition_on"),
            niggli_reduction=s.get("niggli_reduction", False),
            record_trajectories=bool(s.get("record_trajectories", False)),
            seed=self.seed,
        )

    def get_finetuner(self, **finetune_cfg) -> FinetuneStep:
        return FinetuneStep(
            lr=float(finetune_cfg.get("lr", 1e-5)),
            timesteps=int(finetune_cfg.get("timesteps", self.model_config.timesteps)),
            accum_steps=int(finetune_cfg.get("accum_steps", 50)),
            sigma_kl=float(finetune_cfg.get("sigma", 0.025)),
            epochs=int(finetune_cfg.get("epochs", 3)),
        )

    @staticmethod
    def save_model(model: MatterGenDiffusion, save_dir: str | Path) -> None:
        save_model(model, save_dir)
