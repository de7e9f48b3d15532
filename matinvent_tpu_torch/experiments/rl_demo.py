"""RL from scratch: HHI supply-risk minimization (``experiments/rl_demo.py``
of the JAX package), on the card.

    python -m matinvent_tpu_torch.experiments.rl_demo [out=runs/rl_demo] \\
        [family=diffcsp|mattergen] [iters=40] [mode=reward_weighted|ddpo] \\
        [timesteps=] [accum=] [lr=] [ddpo_epochs=] [epochs=3] [sigma=0.1] \\
        [batch=128] [expname=rl_hhi] [ckpt=DIR] [device=cpu]

Synthesizes the demo corpus (``dataset.extxyz``, the JAX tool's file for
the same ``n`` and seed), pretrains a model on it from scratch (DiffCSP
through ``tools.pretrain``, MatterGen through ``pretrain_mattergen``; an
existing MatterGen ``ckpt=`` is reused), then runs the config-driven entry
point ``matinvent_tpu_torch.main`` with JAX's override list and writes
``summary.json`` (``<expname>_summary.json`` for another ``expname``): the
first-5 and last-5 means of ``reward mean``, their difference and the
curve. The family-dependent defaults of ``timesteps``, ``accum``, ``lr``
and ``ddpo_epochs`` are JAX's. Beyond JAX's arguments, ``n`` (corpus size,
400), ``pretrain_steps`` (20000), ``pretrain_batch`` (128), ``hidden``
(128) and ``layers`` (4) size the run down. Everything is written under
``out``; the run is on the card unless ``device=cpu``.
"""
from __future__ import annotations

import copy
import csv
import json
import os
import sys

import numpy as np
import torch

from matinvent_tpu_torch import main as entry_main
from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.main import pop_device
from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite
from matinvent_tpu_torch.parallel.pretrain import PretrainTrainer, structures_to_batches
from matinvent_tpu_torch.tools import pretrain as pretrain_tool
# JAX's ``rl_demo.make_dataset``: the same file for the same arguments
from matinvent_tpu_torch.tools.make_reference_dataset import make_demo_dataset as make_dataset


def pretrain_mattergen(data_path: str, ckpt_dir: str, steps: int = 20000,
                       timesteps: int = 100, batch_size: int = 128,
                       max_atoms: int = 8, hidden_dim: int = 128,
                       num_layers: int = 4, lr: float = 1.5e-3,
                       ema_decay: float | None = None,
                       snapshot_every: int | None = None,
                       device=None, **extra_cfg) -> None:
    """The MatterGen-family pretrain recipe of the JAX experiments:
    ``extra_cfg`` forwards further ``MatterGenConfig`` fields; with
    ``ema_decay`` the saved checkpoint holds the EMA weights, and
    ``snapshot_every`` saves raw and EMA checkpoints as
    ``{ckpt_dir}_s{step}[_ema]``. The weights start from the suite's seed
    (torch's initializers); the batches are JAX's for the same seed."""
    suite = MatterGenSuite(
        model_cfg=dict(hidden_dim=hidden_dim, num_layers=num_layers, time_dim=128,
                       timesteps=timesteps, **extra_cfg),
        sample_cfg={"max_atoms": max_atoms}, device=device,
    )
    model = suite.load_model()
    batches = structures_to_batches(read_extxyz(data_path), batch_size, max_atoms,
                                    np.random.default_rng(0))
    trainer = PretrainTrainer(model, lr=lr, total_steps=steps, ema_decay=ema_decay)

    def save(weights, path):
        snap = copy.deepcopy(model)
        snap.load_state_dict(weights)
        suite.save_model(snap, path)

    def snapshot(step, weights, ema):
        save(weights, f"{ckpt_dir}_s{step}")
        if ema is not None:
            save(ema, f"{ckpt_dir}_s{step}_ema")

    weights, _ = trainer.train(
        batches, steps, torch.Generator(device=model.device).manual_seed(0),
        log_every=max(steps // 20, 1), snapshot_every=snapshot_every,
        snapshot_cb=snapshot if snapshot_every else None,
    )
    model.load_state_dict(weights)
    suite.save_model(model, ckpt_dir)


def reward_column(path: str) -> np.ndarray:
    """The ``reward mean`` column of a ``metrics.csv``, rows without a
    value (empty or NaN) dropped."""
    with open(path) as fh:
        values = [float(r["reward mean"]) for r in csv.DictReader(fh) if r.get("reward mean")]
    return np.asarray([v for v in values if np.isfinite(v)], dtype=float)


def curve_summary(rewards: np.ndarray) -> dict:
    """JAX's summary fields of a reward curve, in its order."""
    first, last = float(np.mean(rewards[:5])), float(np.mean(rewards[-5:]))
    return dict(
        iterations=len(rewards),
        reward_first5_mean=round(first, 4),
        reward_last5_mean=round(last, 4),
        improvement=round(last - first, 4),
    )


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    dev_args = [f"device={device}"] if device else []
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out_dir = os.path.abspath(kv.get("out", "runs/rl_demo"))
    family = kv.get("family", "diffcsp")
    iters = int(kv.get("iters", 40))
    # DiffCSP's discrete cosine schedule needs long chains; MatterGen's
    # continuous SDE handles short ones (JAX's defaults)
    timesteps = int(kv.get("timesteps", 100 if family == "mattergen" else 1000))
    epochs = int(kv.get("epochs", 3))
    accum = int(kv.get("accum", 25 if family == "mattergen" else 50))
    sigma = float(kv.get("sigma", 0.1))
    batch = int(kv.get("batch", 128))
    mode = kv.get("mode", "reward_weighted")
    expname = kv.get("expname", "rl_hhi")
    if mode == "ddpo":
        # MatterGen's lr is T-scaled (the PPO log-prob sums T terms)
        default_lr = (3e-4 * 100.0 / timesteps) if family == "mattergen" else 3e-6
        lr = float(kv.get("lr", default_lr))
        ddpo_epochs = int(kv.get("ddpo_epochs", 2 if family == "mattergen" else 1))
    else:
        lr = float(kv.get("lr", 1e-4))
        ddpo_epochs = int(kv.get("ddpo_epochs", 1))
    hidden, layers = int(kv.get("hidden", 128)), int(kv.get("layers", 4))
    pretrain_steps = int(kv.get("pretrain_steps", 20000))
    pretrain_batch = int(kv.get("pretrain_batch", 128))
    os.makedirs(out_dir, exist_ok=True)

    model_cfg = [
        f"model.model_cfg.hidden_dim={hidden}",
        f"model.model_cfg.num_layers={layers}",
        "model.model_cfg.time_dim=128",
        f"model.model_cfg.timesteps={timesteps}",
    ]
    data_path = os.path.join(out_dir, "dataset.extxyz")
    make_dataset(data_path, n=int(kv.get("n", 400)))
    print(f"[demo] dataset: {data_path}", flush=True)

    ckpt_dir = os.path.abspath(kv.get("ckpt", os.path.join(out_dir, "pretrained")))
    if family == "mattergen":
        if not os.path.exists(os.path.join(ckpt_dir, "params.msgpack")):
            pretrain_mattergen(data_path, ckpt_dir, steps=pretrain_steps, timesteps=timesteps,
                               batch_size=pretrain_batch, hidden_dim=hidden, num_layers=layers,
                               device=device)
    else:
        pretrain_tool.main(
            [f"data={data_path}", f"output_dir={ckpt_dir}", f"steps={pretrain_steps}",
             f"batch_size={pretrain_batch}", "max_atoms=8", "lr=1.5e-3"] + model_cfg + dev_args)
    print(f"[demo] pretrained: {ckpt_dir}", flush=True)

    cwd = os.getcwd()
    try:
        entry_main.main([
            f"results_dir={out_dir}", f"expname={expname}", "seed=0",
            f"rl_epoch={iters}", "eval_size=16",
            "reward=hhi", "logger=csv",
            f"model={family if family == 'mattergen' else 'diffcsp'}",
            f"model.model_path={ckpt_dir}",
            "+model.config_overrides.sample_clip=30.0",
            f"model.sample_cfg.batch_size={batch}",
            "model.sample_cfg.max_atoms=8",
            f"model.finetune_cfg.timesteps={timesteps}",
            f"pipeline.finetune_cfg.accum_steps={accum}",
            f"pipeline.finetune_cfg.epochs={epochs}",
            f"pipeline.finetune_cfg.sigma={sigma}",
            f"model.finetune_cfg.lr={lr}",
            f"+model.finetune_cfg.ddpo_epochs={ddpo_epochs}",
            f"+pipeline.finetune_mode={mode}",
            f"pipeline.save_freq={iters}",
            "sample_cfg.filter=null",
        ] + dev_args)
    finally:
        os.chdir(cwd)

    rewards = reward_column(os.path.join(out_dir, expname, "metrics.csv"))
    summary = dict(curve_summary(rewards), reward_curve=[round(float(r), 4) for r in rewards])
    name = "summary.json" if expname == "rl_hhi" else f"{expname}_summary.json"
    with open(os.path.join(out_dir, name), "w") as fh:
        json.dump(summary, fh, indent=2)
        fh.write("\n")
    print("[demo] " + json.dumps({k: v for k, v in summary.items() if k != "reward_curve"}),
          flush=True)
    return summary


if __name__ == "__main__":
    main()
