"""The model facade of the RL loop (``matinvent_tpu/models/suite/base.py``).

A suite builds its diffusion module and loads its weights (a checkpoint, or
an initialization from ``seed``), hands out a sampler and a fine-tune
step, and saves checkpoints that both packages read.
"""
from __future__ import annotations

from pathlib import Path

from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.utils.config import read_flat_yaml


class ModelSuite:
    def __init__(
        self,
        model_name: str,
        sample_cfg: dict | None = None,
        finetune_cfg: dict | None = None,
        model_path: str | None = None,
        config_overrides: dict | None = None,
        seed: int = 0,
        device=None,
    ) -> None:
        self.model_name = model_name
        self.sample_cfg = dict(sample_cfg or {})
        self.finetune_cfg = dict(finetune_cfg or {})
        self.model_path = model_path
        self.config_overrides = dict(config_overrides or {})
        self.seed = seed
        self.device = resolve_device(device)

    def resolve_model_config(self, model_cfg: dict | None) -> dict:
        """A checkpoint directory's ``config.yaml`` is authoritative over the
        recipe's ``model_cfg``; only ``config_overrides`` apply on top."""
        cfg = dict(model_cfg or {})
        if self.model_path is not None:
            cfg_file = Path(self.model_path) / "config.yaml"
            if cfg_file.exists():
                cfg = read_flat_yaml(cfg_file)
        cfg.update(self.config_overrides)
        return cfg

    def load_model(self):
        raise NotImplementedError

    def get_sampler(self):
        raise NotImplementedError

    def get_finetuner(self, **finetune_cfg):
        raise NotImplementedError

    def save_model(self, model, save_dir: str):
        raise NotImplementedError
