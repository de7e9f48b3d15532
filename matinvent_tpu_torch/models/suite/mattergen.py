"""MatterGen model suite (``matinvent_tpu/models/suite/mattergen.py``).

A checkpoint directory holds ``config.yaml`` (one ``key: value`` line per
``MatterGenConfig`` field) and the weights. The port builds
``MatterGenDiffusion`` from the first and reads the weights as the JAX
suite does: ``params.msgpack`` (the flax tree of the JAX package's
``MatterGenDiffusion`` in flax's serialization, ``utils/msgpack.py``)
first, then a torch ``*.ckpt`` (the first whose name holds ``last``, else
the last by name) through ``mattergen_import``, which refuses GemNet
checkpoints, and only then the port's own ``state_dict.npz`` (torch-layout
weights under ``decoder.``). ``save_model`` writes ``params.msgpack``,
``state_dict.npz`` and ``config.yaml``, which the JAX suite loads.

``params_from_jax`` turns the JAX package's flax parameter tree (as numpy)
into the port's state dict, by the naming rules of ``mattergen_import``,
and ``params_to_jax`` turns it back.
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
from matinvent_tpu_torch.models.suite.mattergen_import import (
    mattergen_params_from_state_dict,
    mattergen_state_dict_from_params,
)
from matinvent_tpu_torch.models.suite.torch_import import load_torch_checkpoint
from matinvent_tpu_torch.parallel.train import FinetuneStep
from matinvent_tpu_torch.utils import msgpack
from matinvent_tpu_torch.utils.msgpack import restore
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


# flax params (nested dicts of arrays, optionally under ``'params'``) -> a
# torch-layout state dict of float32 numpy arrays, by mattergen_import's rules
params_from_jax = mattergen_state_dict_from_params


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
    load_weights(model, model_path)
    return model.eval()


def load_weights(model: MatterGenDiffusion, model_path: str | Path) -> None:
    """Load a checkpoint directory's weights into ``model``, in the JAX
    suite's order: ``params.msgpack``, then a ``*.ckpt`` (the first by name
    holding ``last``, else the last), then ``state_dict.npz``."""
    path = Path(model_path)
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    ckpts = sorted(path.glob("*.ckpt"))
    if (path / "params.msgpack").exists():
        with open(path / "params.msgpack", "rb") as fh:
            params = restore(params_to_jax(sd, model), msgpack.unpackb(fh.read()))
        weights = params_from_jax(params)
    elif ckpts:
        ckpt = next((c for c in ckpts if "last" in c.name), ckpts[-1])
        params = mattergen_params_from_state_dict(
            load_torch_checkpoint(str(ckpt)), params_to_jax(sd, model)
        )
        weights = params_from_jax(params)
    elif (path / "state_dict.npz").exists():
        with np.load(path / "state_dict.npz") as npz:
            weights = {k: npz[k] for k in npz.files}
    else:
        raise FileNotFoundError(
            f"no params.msgpack or *.ckpt under {model_path} — "
            "convert checkpoints with python -m "
            "matinvent_tpu_torch.tools.convert_mattergen_ckpt"
        )
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()},
                          strict=True)


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
        load_weights(model, self.model_path)
        return model.eval()

    def get_sampler(self) -> MatterGenSampler:
        s = self.sample_cfg
        return MatterGenSampler(
            batch_size=s.get("batch_size"),
            num_batches=s.get("num_batches"),
            num_atoms_distribution=s.get("num_atoms_distribution", "mp_20"),
            num_atoms_distribution_file=s.get("num_atoms_distribution_file"),
            max_atoms=s.get("max_atoms", 20),
            diffusion_guidance_factor=s.get("diffusion_guidance_factor", 0.0),
            properties_to_condition_on=s.get("properties_to_condition_on"),
            target_compositions_dict=s.get("target_compositions_dict"),
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
