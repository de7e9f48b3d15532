"""Pretrain a DiffCSP-class model on a structure dataset
(``tools/pretrain.py`` of the JAX package), on the card.

    python -m matinvent_tpu_torch.tools.pretrain data=<dataset.extxyz> \\
        output_dir=<ckpt_dir> [steps=20000] [batch_size=128] [lr=1e-3] \\
        [max_atoms=20] [seed=0] [model.model_cfg.hidden_dim=128 ...] [device=cpu]

The model's widths are ``configs/model/diffcsp.yaml``'s with the
``model...`` overrides. It writes a checkpoint directory (``params.msgpack``,
``config.yaml``, ``state_dict.npz``) that both packages' ``DiffCSPSuite``
load (``model.model_path=...``). The weights start from ``seed`` (torch's
initializers, not flax's); the batches are the JAX tool's for the same seed.
"""
from __future__ import annotations

import logging
import sys

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.main import CONFIG_DIR, pop_device
from matinvent_tpu_torch.models.suite.diffcsp import DiffCSPSuite
from matinvent_tpu_torch.parallel.pretrain import PretrainTrainer, structures_to_batches
from matinvent_tpu_torch.pipeline.logger import setup_logging
from matinvent_tpu_torch.utils.config import load_config


def main(argv: list[str] | None = None):
    """Trains and saves; returns the trained model and the loss history."""
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(device)
    setup_logging()
    kv = dict(a.split("=", 1) for a in argv if "=" in a and not a.startswith("model"))
    data_path = kv.pop("data")
    output_dir = kv.pop("output_dir", "pretrained")
    steps = int(kv.pop("steps", 20000))
    batch_size = int(kv.pop("batch_size", 128))
    lr = float(kv.pop("lr", 1e-3))
    max_atoms = int(kv.pop("max_atoms", 20))
    seed = int(kv.pop("seed", 0))
    if kv:
        raise ValueError(f"unknown arguments: {sorted(kv)}")

    model_overrides = [a for a in argv if a.startswith("model")]
    cfg = load_config(CONFIG_DIR, "base", overrides=["model=diffcsp"] + model_overrides)
    suite = DiffCSPSuite(model_name="diffcsp", model_cfg=cfg["model"].get("model_cfg"),
                         sample_cfg={"max_atoms": max_atoms}, seed=seed, device=device)
    model = suite.load_model()

    structures = read_extxyz(data_path)
    logging.info(f"loaded {len(structures)} structures from {data_path}")
    batches = structures_to_batches(structures, batch_size, max_atoms, np.random.default_rng(seed))
    trainer = PretrainTrainer(model, lr=lr, total_steps=steps)
    generator = torch.Generator(device=device).manual_seed(seed)
    weights, history = trainer.train(batches, steps, generator, log_every=max(steps // 50, 1))
    model.load_state_dict(weights)
    suite.save_model(model, output_dir)
    logging.info(f"saved pretrained checkpoint to {output_dir}")
    return model, history


if __name__ == "__main__":
    main()
