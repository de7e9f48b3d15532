"""DiffCSP model suite (``matinvent_tpu/models/suite/diffcsp.py``).

A checkpoint directory holds ``config.yaml`` (one ``key: value`` line per
``DiffCSPConfig`` field), ``params.msgpack`` (the flax tree of the JAX
package's ``CSPNet``, which the JAX suite reads first) and
``state_dict.npz`` (the reference torch layout); a reference checkpoint
holds a torch ``*.ckpt`` instead. ``load_model`` reads ``params.msgpack``
with the port's msgpack decoder, or else the ``.ckpt`` through
``torch_import``, and carries the flax tree into the port's ``CSPNet``
(``params_from_jax``). Scalers shipped with a checkpoint
(``scalers.npz``, or the reference's pickled ``lattice_scaler.pt`` /
``prop_scaler.pt``) are attached to the suite and the module and written
back by ``save_model``; as in the JAX package, sampling and the fine-tune
never apply them. ``save_model`` writes the three files as the JAX suite
writes them, so the JAX suite loads the port's directory.
"""
from __future__ import annotations

import os
import sys
import types
from pathlib import Path

import numpy as np
import torch

from matinvent_tpu_torch.models.diffcsp import DiffCSPConfig, DiffCSPDiffusion
from matinvent_tpu_torch.models.sample import DiffCSPSampler
from matinvent_tpu_torch.models.suite.base import ModelSuite
from matinvent_tpu_torch.models.suite.mattergen import params_from_jax, params_to_jax
from matinvent_tpu_torch.models.suite.torch_import import (
    cspnet_params_from_state_dict,
    cspnet_state_dict_from_params,
    load_torch_checkpoint,
)
from matinvent_tpu_torch.parallel.train import FinetuneStep
from matinvent_tpu_torch.utils import msgpack
from matinvent_tpu_torch.utils.msgpack import leaf_shapes, restore
from matinvent_tpu_torch.utils.config import write_flat_yaml
from matinvent_tpu_torch.utils.scaler import StandardScaler


def _torch_load_scaler(path: str):
    """``torch.load`` a pickled reference scaler: its class lives in the
    reference's ``models.diffcsp.utils``, so a stand-in module with a plain
    attribute-bag class of that name is registered before unpickling."""
    mod_name = "models.diffcsp.utils"
    if mod_name not in sys.modules:
        class _ScalerStub:  # noqa: N801 - the unpickling target
            def __setstate__(self, state):
                self.__dict__.update(state)

        mod_utils = types.ModuleType(mod_name)
        mod_utils.StandardScalerTorch = _ScalerStub
        for name, mod in (
            ("models", types.ModuleType("models")),
            ("models.diffcsp", types.ModuleType("models.diffcsp")),
            (mod_name, mod_utils),
        ):
            sys.modules.setdefault(name, mod)
    return torch.load(path, map_location="cpu", weights_only=False)


class DiffCSPSuite(ModelSuite):
    def __init__(
        self,
        model_name: str = "diffcsp",
        sample_cfg: dict | None = None,
        finetune_cfg: dict | None = None,
        model_path: str | None = None,
        model_cfg: dict | None = None,
        config_overrides: dict | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(model_name, sample_cfg, finetune_cfg, model_path,
                         config_overrides, seed, device)
        self.model_config = DiffCSPConfig.from_dict(self.resolve_model_config(model_cfg))
        self.lattice_scaler = None
        self.prop_scaler = None

    # ------------------------------------------------------------------ load
    def load_model(self) -> DiffCSPDiffusion:
        """A new module with the checkpoint's weights, or, without a
        ``model_path``, weights initialized from ``seed``."""
        if self.model_path is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self.seed)
                return DiffCSPDiffusion(self.model_config, device=self.device).eval()
        model = DiffCSPDiffusion(self.model_config, device=self.device)
        path = Path(self.model_path)
        sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
        template = params_to_jax(sd, model)
        if (path / "params.msgpack").exists():
            with open(path / "params.msgpack", "rb") as fh:
                params = restore(template, msgpack.unpackb(fh.read()))
        else:
            # reference checkpoints: last.ckpt if present, else the newest
            ckpts = sorted(path.glob("*.ckpt"))
            ckpt = next((ck for ck in reversed(ckpts) if "last" in ck.name),
                        ckpts[-1] if ckpts else None)
            if ckpt is None:
                raise FileNotFoundError(f"no checkpoint found under {path}")
            params = cspnet_params_from_state_dict(
                load_torch_checkpoint(str(ckpt)), num_layers=self.model_config.num_layers,
                ln=self.model_config.ln,
            )
        if leaf_shapes(params) != leaf_shapes(template):
            raise ValueError(f"the checkpoint under {path} does not match the config's widths")
        weights = params_from_jax(params)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()}, strict=True)
        self._load_scalers(path)
        model.lattice_scaler, model.prop_scaler = self.lattice_scaler, self.prop_scaler
        return model.eval()

    def _load_scalers(self, path: Path) -> None:
        """The lattice and property scalers of a checkpoint directory
        (``scalers.npz``, else ``lattice_scaler.pt`` / ``prop_scaler.pt``)."""
        self.lattice_scaler = None
        self.prop_scaler = None
        npz = path / "scalers.npz"
        if npz.exists():
            with np.load(npz) as data:
                if "lattice_means" in data:
                    self.lattice_scaler = StandardScaler(data["lattice_means"], data["lattice_stds"])
                if "prop_means" in data:
                    self.prop_scaler = StandardScaler(data["prop_means"], data["prop_stds"])
            return
        for attr, fname in (("lattice_scaler", "lattice_scaler.pt"),
                            ("prop_scaler", "prop_scaler.pt")):
            f = path / fname
            if not f.exists():
                continue
            obj = _torch_load_scaler(str(f))
            means, stds = (obj["means"], obj["stds"]) if isinstance(obj, dict) else (obj.means, obj.stds)
            means = np.asarray(means.numpy() if hasattr(means, "numpy") else means)
            stds = np.asarray(stds.numpy() if hasattr(stds, "numpy") else stds)
            setattr(self, attr, StandardScaler(means, stds))

    # ------------------------------------------------- sampler and fine-tune
    def get_sampler(self) -> DiffCSPSampler:
        s = self.sample_cfg
        return DiffCSPSampler(
            batch_size=s.get("batch_size"),
            num_batches=s.get("num_batches"),
            num_atoms_distribution=s.get("num_atoms_distribution", "mp_20"),
            num_atoms_distribution_file=s.get("num_atoms_distribution_file"),
            max_atoms=s.get("max_atoms", 20),
            step_lr=s.get("step_lr"),
            record_trajectories=bool(s.get("record_trajectories", False)),
            seed=self.seed,
        )

    def get_finetuner(self, **finetune_cfg) -> FinetuneStep:
        return FinetuneStep(
            lr=float(finetune_cfg.get("lr", 1e-4)),
            timesteps=int(finetune_cfg.get("timesteps", self.model_config.timesteps)),
            accum_steps=int(finetune_cfg.get("accum_steps", 50)),
            sigma_kl=float(finetune_cfg.get("sigma", 0.025)),
            epochs=int(finetune_cfg.get("epochs", 3)),
        )

    # ------------------------------------------------------------------ save
    def save_model(self, model: DiffCSPDiffusion, save_dir: str | Path) -> None:
        """``params.msgpack``, ``config.yaml`` and ``state_dict.npz`` (the
        reference torch layout) of ``model``, and ``scalers.npz`` when the
        suite carries scalers, as the JAX suite writes them."""
        os.makedirs(save_dir, exist_ok=True)
        # sorted keys: flax serializes the tree in sorted order
        sd = {k: v.detach().cpu().numpy() for k, v in sorted(model.state_dict().items())}
        params = params_to_jax(sd, model)
        with open(os.path.join(save_dir, "params.msgpack"), "wb") as fh:
            fh.write(msgpack.packb(params))
        cfg = {f: getattr(model.config, f) for f in DiffCSPConfig.__dataclass_fields__}
        write_flat_yaml(os.path.join(save_dir, "config.yaml"), cfg)
        np.savez(os.path.join(save_dir, "state_dict.npz"), **cspnet_state_dict_from_params(params))
        arrays = {}
        for name, sc in (("lattice", self.lattice_scaler), ("prop", self.prop_scaler)):
            if sc is not None:
                arrays[f"{name}_means"] = np.asarray(sc.means)
                arrays[f"{name}_stds"] = np.asarray(sc.stds)
        if arrays:
            np.savez(os.path.join(save_dir, "scalers.npz"), **arrays)
