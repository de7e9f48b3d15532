"""Train one GNN property predictor for the reward calculators, with
argparse options and the analytic proxy labels: a thin wrapper over
``matinvent_tpu_torch.tools.train_predictor`` (which takes the JAX tool's
``key=value`` arguments).

    python -m matinvent_tpu_torch.experiments.train_predictor --data DATA.extxyz \\
        (--labels LABELS.txt | --proxy) --model-name mp_bandgap --output-dir DIR \\
        [--steps 5000] [--batch-size 64] [--lr 1e-3] [--device cpu]

``--proxy`` labels every structure of ``--data`` with the analytic proxy of
``chem/proxy_labels`` for ``--model-name``. Writes what the tool writes and
prints one JSON record.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from matinvent_tpu_torch.chem.proxy_labels import label_structures
from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.pipeline.logger import setup_logging
from matinvent_tpu_torch.tools.train_predictor import train


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
        values = label_structures(structures, args.model_name)
        label_source = f"proxy:{args.model_name}"
    else:
        values = np.loadtxt(args.labels)
        label_source = args.labels
    rec = train(structures, values, model_name=args.model_name, output_dir=args.output_dir,
                steps=args.steps, batch_size=args.batch_size, lr=args.lr,
                max_atoms=args.max_atoms, seed=args.seed, hidden_dim=args.hidden_dim,
                num_layers=args.num_layers, label_source=label_source, device=args.device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
