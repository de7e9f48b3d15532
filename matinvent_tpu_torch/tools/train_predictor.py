"""Train a GNN property predictor for the reward calculators
(``tools/train_predictor.py`` of the JAX package).

    python -m matinvent_tpu_torch.tools.train_predictor data=<dataset.extxyz> \\
        labels=<labels.txt> model_name=mp_bandgap output_dir=<model_dir> \\
        [steps=5000] [batch_size=64] [lr=1e-3] [max_atoms=32] [seed=0] \\
        [hidden_dim=128] [num_layers=4] [label_source=...] [device=cpu]

Standardizes the labels (one value per structure of ``data``), holds out a
tenth of the structures (at least one), trains a ``PropertyGNN`` with
``PredictorTrainer`` on the rest and writes ``<output_dir>/<model_name>.msgpack``
in the JAX package's format (``{"params": {"params": tree}, "y_mean",
"y_std"}``, flax's serialization, which ``PropertyGNN`` of either package
loads through ``model_dir``) and ``<model_name>.meta.txt`` with the held-out
R^2 and MAE in the label's units (``val_r2``, ``val_mae``, ``steps``,
``y_mean``, ``y_std``, ``labels``: ``label_source``, the labels file by
default). Runs on the card unless ``device=cpu`` is given.
"""
from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np

from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.main import pop_device
from matinvent_tpu_torch.models.suite.mattergen import params_to_jax
from matinvent_tpu_torch.parallel.train_predictor import PredictorTrainer, labeled_batches
from matinvent_tpu_torch.pipeline.logger import setup_logging
from matinvent_tpu_torch.rewards.calculators.predictor import PropertyGNN
from matinvent_tpu_torch.utils import msgpack


def checkpoint_bytes(gnn: PropertyGNN, y_mean: float, y_std: float) -> bytes:
    """``gnn``'s weights and label scaler in flax's ``to_bytes`` format."""
    sd = {k: v.detach().cpu().numpy() for k, v in gnn.net.state_dict().items()}
    ckpt = {"params": params_to_jax(sd, gnn.net, prefix=""), "y_mean": float(y_mean),
            "y_std": float(y_std)}
    return msgpack.packb(ckpt)


def train(
    structures: list,
    labels: np.ndarray,
    *,
    model_name: str = "mp_bandgap",
    output_dir: str = "predictors",
    steps: int = 5000,
    batch_size: int = 64,
    lr: float = 1e-3,
    max_atoms: int = 32,
    seed: int = 0,
    hidden_dim: int = 128,
    num_layers: int = 4,
    label_source: str = "",
    device=None,
) -> dict:
    """Train, report on the held-out tenth and write the checkpoint and its
    ``.meta.txt``; returns a record of the run (losses, R^2, MAE, scaler)."""
    labels = np.asarray(labels, dtype=float)
    if len(structures) != len(labels):
        raise ValueError("data/labels length mismatch")
    # standardized targets; the scaler ships inside the checkpoint and
    # PropertyGNN de-standardizes at predict time
    finite = labels[np.isfinite(labels)]
    y_mean = float(finite.mean())
    y_std = float(max(finite.std(), 1e-6))
    labels_std = (labels - y_mean) / y_std

    gnn = PropertyGNN(model_name, hidden_dim=hidden_dim, num_layers=num_layers,
                      max_atoms=max_atoms, seed=seed, device=device)
    trainer = PredictorTrainer(gnn, lr=lr)
    rng = np.random.default_rng(seed)
    # held-out split for an honest fit report
    n_val = max(len(structures) // 10, 1)
    perm = rng.permutation(len(structures))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    batches = labeled_batches([structures[i] for i in train_idx], labels_std[train_idx],
                              batch_size, max_atoms, rng)
    t0 = time.perf_counter()
    history = trainer.train(batches, steps, log_every=max(steps // 50, 1))
    train_seconds = time.perf_counter() - t0

    # validation R^2 and MAE in the label's units
    gnn.y_mean, gnn.y_std = y_mean, y_std
    val = [structures[i] for i in val_idx]
    usable = [i for i, s in enumerate(val) if s.num_atoms <= max_atoms]
    preds = gnn.predict([val[i] for i in usable])
    truth = labels[val_idx][usable]
    ok = np.isfinite(preds) & np.isfinite(truth)
    ss_res = float(np.sum((preds[ok] - truth[ok]) ** 2))
    ss_tot = float(np.sum((truth[ok] - truth[ok].mean()) ** 2))
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    mae = float(np.mean(np.abs(preds[ok] - truth[ok])))
    logging.info(f"validation: R2={r2:.4f} MAE={mae:.4f} (n={int(ok.sum())})")

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{model_name}.msgpack")
    with open(path, "wb") as fh:
        fh.write(checkpoint_bytes(gnn, y_mean, y_std))
    # label provenance travels with the weights: val_r2 is measured against
    # whatever produced the labels
    with open(os.path.join(output_dir, f"{model_name}.meta.txt"), "w") as fh:
        fh.write(f"val_r2={r2:.5f}\nval_mae={mae:.5f}\nsteps={steps}\n"
                 f"y_mean={y_mean}\ny_std={y_std}\nlabels={label_source}\n")
    logging.info(f"saved predictor to {path}")
    return dict(model_name=model_name, path=path, steps=steps, val_r2=r2, val_mae=mae,
                losses=history, train_seconds=train_seconds, y_mean=y_mean, y_std=y_std,
                val_index=val_idx.tolist())


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(device)
    setup_logging()
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    structures = read_extxyz(kv["data"])
    labels = np.loadtxt(kv["labels"])
    return train(
        structures, labels,
        model_name=kv.get("model_name", "mp_bandgap"),
        output_dir=kv.get("output_dir", "predictors"),
        steps=int(kv.get("steps", 5000)),
        batch_size=int(kv.get("batch_size", 64)),
        lr=float(kv.get("lr", 1e-3)),
        max_atoms=int(kv.get("max_atoms", 32)),
        seed=int(kv.get("seed", 0)),
        hidden_dim=int(kv.get("hidden_dim", 128)),
        num_layers=int(kv.get("num_layers", 4)),
        label_source=kv.get("label_source", kv["labels"]),
        device=device,
    )


if __name__ == "__main__":
    main()
