"""Train one GNN property predictor for the reward calculators
(``tools/train_predictor.py``).

    python -m matinvent_tpu_torch.experiments.train_predictor --data DATA.extxyz \\
        (--labels LABELS.txt | --proxy) --model-name mp_bandgap --output-dir DIR \\
        [--steps 5000] [--batch-size 64] [--lr 1e-3] [--device cpu]

Standardizes the labels (``--labels``: one value per structure of
``--data``; ``--proxy``: the analytic proxy labels of ``chem/proxy_labels``
for ``--model-name``), holds out a tenth of the structures, trains with
``PredictorTrainer`` and writes ``<output-dir>/<model-name>.msgpack`` in the
JAX package's format (``{"params": {"params": tree}, "y_mean", "y_std"}``,
flax's serialization, which ``PropertyGNN`` of either package loads) and a
``.meta.txt`` with the held-out R^2 and MAE. Prints one JSON record.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

from matinvent_tpu_torch.chem.proxy_labels import label_structures
from matinvent_tpu_torch.chem.structure import read_extxyz
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


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data", required=True)
    labels = parser.add_mutually_exclusive_group(required=True)
    labels.add_argument("--labels")
    labels.add_argument("--proxy", action="store_true")
    parser.add_argument("--model-name", default="mp_bandgap")
    parser.add_argument("--output-dir", default="predictors")
    parser.add_argument("--steps", type=int, default=5000)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--max-atoms", type=int, default=32)
    parser.add_argument("--hidden-dim", type=int, default=128)
    parser.add_argument("--num-layers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="cpu to run on the CPU")
    args = parser.parse_args(argv)
    setup_logging()

    structures = read_extxyz(args.data)
    if args.proxy:
        labels_all = label_structures(structures, args.model_name)
        label_source = f"proxy:{args.model_name}"
    else:
        labels_all = np.loadtxt(args.labels)
        label_source = args.labels
    if len(structures) != len(labels_all):
        raise ValueError("data/labels length mismatch")

    # standardized targets; the scaler ships inside the checkpoint
    finite = labels_all[np.isfinite(labels_all)]
    y_mean = float(finite.mean())
    y_std = float(max(finite.std(), 1e-6))
    labels_std = (labels_all - y_mean) / y_std

    gnn = PropertyGNN(args.model_name, hidden_dim=args.hidden_dim, num_layers=args.num_layers,
                      max_atoms=args.max_atoms, seed=args.seed, device=args.device)
    trainer = PredictorTrainer(gnn, lr=args.lr)
    rng = np.random.default_rng(args.seed)
    n_val = max(len(structures) // 10, 1)
    perm = rng.permutation(len(structures))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    batches = labeled_batches([structures[i] for i in train_idx], labels_std[train_idx],
                              args.batch_size, args.max_atoms, rng)
    t0 = time.perf_counter()
    history = trainer.train(batches, args.steps, log_every=max(args.steps // 50, 1))
    train_seconds = time.perf_counter() - t0

    # held-out R^2 and MAE in the label's units
    gnn.y_mean, gnn.y_std = y_mean, y_std
    val = [structures[i] for i in val_idx]
    usable = [i for i, s in enumerate(val) if s.num_atoms <= args.max_atoms]
    preds = gnn.predict([val[i] for i in usable])
    truth = labels_all[val_idx][usable]
    ok = np.isfinite(preds) & np.isfinite(truth)
    ss_res = float(np.sum((preds[ok] - truth[ok]) ** 2))
    ss_tot = float(np.sum((truth[ok] - truth[ok].mean()) ** 2))
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    mae = float(np.mean(np.abs(preds[ok] - truth[ok])))
    logging.info(f"validation: R2={r2:.4f} MAE={mae:.4f} (n={int(ok.sum())})")

    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, f"{args.model_name}.msgpack")
    with open(path, "wb") as fh:
        fh.write(checkpoint_bytes(gnn, y_mean, y_std))
    with open(os.path.join(args.output_dir, f"{args.model_name}.meta.txt"), "w") as fh:
        fh.write(f"val_r2={r2:.5f}\nval_mae={mae:.5f}\nsteps={args.steps}\n"
                 f"y_mean={y_mean}\ny_std={y_std}\nlabels={label_source}\n")
    logging.info(f"saved predictor to {path}")
    rec = dict(model_name=args.model_name, path=path, steps=args.steps, val_r2=r2, val_mae=mae,
               losses=history, train_seconds=train_seconds, y_mean=y_mean, y_std=y_std)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
