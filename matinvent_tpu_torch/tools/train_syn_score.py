"""Train the SynScore synthesizability ensemble
(``tools/train_syn_score.py`` of the JAX package), on the card.

    python -m matinvent_tpu_torch.tools.train_syn_score [out=syn_score.npz] \\
        [n=20000] [steps=3000] [n_models=100] [seed=0] [lr=3e-3] [device=cpu]

Compositions are drawn as the JAX tool draws them (balanced ionic pairs,
perturbed ones, arbitrary multisets) and labeled by ``smact_valid``; the
features are SynScore's 90-dim composition embeddings, standardized. All
``n_models`` bags train at once: their parameters are stacked ``[E, ...]``,
each bag has its own bootstrap index table, and one Adam step (optax's
defaults) covers the whole ensemble axis through batched products. The
standardization is folded into the first layer, and the ensemble is
written as ``out`` (``w1``, ``b1``, ``w2``, ``b2``), which both packages'
``SynScore(model_path=...)`` load, with its validation accuracy and AUC
in ``<out stem>.meta.txt``.
"""
from __future__ import annotations

import os
import sys
import tempfile
from math import gcd

import numpy as np
import torch

from matinvent_tpu_torch.chem.composition import Composition
from matinvent_tpu_torch.chem.data import OXIDATION_STATES, SYMBOLS, Z_BY_SYMBOL
from matinvent_tpu_torch.chem.validity import smact_valid
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.main import pop_device
from matinvent_tpu_torch.rewards.calculators.syn_score import (
    EMB_DIM,
    HID_DIM,
    SynScore,
    ensemble_forward,
)

BATCH = 512


def sample_compositions(n: int, seed: int) -> list[Composition]:
    """40% exactly balanced ionic compositions, 30% the same with one count
    perturbed, 30% arbitrary multisets; ``smact_valid`` labels them."""
    rng = np.random.default_rng(seed)
    syms = [s for s in SYMBOLS[1:84] if s in Z_BY_SYMBOL]
    cations = [
        (s, [o for o in OXIDATION_STATES.get(s, []) if o > 0])
        for s in syms if any(o > 0 for o in OXIDATION_STATES.get(s, []))
    ]
    anions = [
        (s, [o for o in OXIDATION_STATES.get(s, []) if o < 0])
        for s in ("O", "S", "Se", "Te", "F", "Cl", "Br", "I", "N", "P", "As")
        if any(o < 0 for o in OXIDATION_STATES.get(s, []))
    ]

    def balanced_pair():
        cs, cox = cations[rng.integers(len(cations))]
        as_, aox = anions[rng.integers(len(anions))]
        op = int(rng.choice(cox))
        on = -int(rng.choice(aox))
        g = gcd(op, on)
        return cs, as_, on // g, op // g

    out = []
    for _ in range(n):
        u = rng.random()
        if u < 0.7:
            cs, as_, ncat, nan_ = balanced_pair()
            if u >= 0.4:
                if rng.random() < 0.5:
                    ncat += int(rng.integers(1, 3))
                else:
                    nan_ += int(rng.integers(1, 3))
            comp = {cs: ncat, as_: nan_}
            if rng.random() < 0.25:
                cs2, as2, n2, m2 = balanced_pair()
                comp[cs2] = comp.get(cs2, 0) + n2
                comp[as2] = comp.get(as2, 0) + m2
            out.append(Composition(comp))
        else:
            k = int(rng.integers(1, 5))
            els = list(rng.choice(syms, size=k, replace=False))
            counts = rng.integers(1, 9, size=k)
            out.append(Composition({e: int(c) for e, c in zip(els, counts)}))
    return out


class _Comp:
    """A structure stand-in: ``comp_embedding`` reads ``.composition``."""

    def __init__(self, composition: Composition):
        self.composition = composition


def prepare(n: int, seed: int, n_models: int) -> dict[str, np.ndarray]:
    """The labeled, featurized, standardized and split data and the bags'
    bootstrap tables, drawn as the JAX tool draws them."""
    comps = sample_compositions(n, seed)
    labels = np.array([1 if smact_valid(c) else 0 for c in comps], np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        scorer = SynScore(root_dir=tmp, n_models=n_models, seed=seed, device="cpu")
        X = np.stack([scorer.comp_embedding(_Comp(c)) for c in comps]).astype(np.float32)
    ok = ~np.isnan(X).any(axis=1)
    X, labels = X[ok], labels[ok]
    mu, sd = X.mean(0), X.std(0) + 1e-6
    Xs = (X - mu) / sd
    rng = np.random.default_rng(seed)
    n_val = len(X) // 10
    perm = rng.permutation(len(X))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    boots = rng.integers(0, len(train_idx), size=(n_models, len(train_idx)))
    return dict(mu=mu, sd=sd, Xtr=Xs[train_idx], ytr=labels[train_idx],
                Xva_raw=X[val_idx], yva=labels[val_idx], boots=boots)


def init_params(n_models: int, generator: torch.Generator, device) -> dict[str, torch.Tensor]:
    E = n_models
    return {
        "w1": torch.randn((E, EMB_DIM, HID_DIM), generator=generator, device=device)
        * (1 / np.sqrt(EMB_DIM)),
        "b1": torch.zeros((E, HID_DIM), device=device),
        "w2": torch.randn((E, HID_DIM, 2), generator=generator, device=device)
        * (1 / np.sqrt(HID_DIM)),
        "b2": torch.zeros((E, 2), device=device),
    }


def ensemble_loss(params: dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean over the bags of each bag's cross-entropy on its rows
    (``x [E, b, 90]``, ``y [E, b]``)."""
    h = torch.matmul(x, params["w1"]) + params["b1"][:, None, :]
    h = torch.logaddexp(h, torch.zeros((), dtype=h.dtype, device=h.device))  # softplus
    logits = torch.matmul(h, params["w2"]) + params["b2"][:, None, :]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, y[..., None].long())[..., 0]
    return torch.mean(torch.mean(nll, dim=1))


def train_ensemble(params: dict[str, torch.Tensor], Xtr: np.ndarray, ytr: np.ndarray,
                   boots: np.ndarray, steps: int, lr: float,
                   generator: torch.Generator | None = None, cols=None,
                   log_every: int | None = None) -> list[float]:
    """``steps`` Adam steps on ``params`` (in place): each bag's batch is
    ``BATCH`` rows of its bootstrap table, at columns drawn from
    ``generator`` (or ``cols[step]``, ``[E, BATCH]``). Returns the losses."""
    dev = params["w1"].device
    for v in params.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    X = torch.as_tensor(Xtr, device=dev)
    y = torch.as_tensor(ytr, device=dev)
    table = torch.as_tensor(boots, device=dev)
    E, n_train = table.shape
    losses = []
    for step in range(steps):
        if cols is None:
            c = torch.randint(0, n_train, (E, BATCH), generator=generator, device=dev)
        else:
            c = torch.as_tensor(np.array(cols[step]), device=dev).long()
        idx = torch.gather(table, 1, c)
        opt.zero_grad(set_to_none=True)
        loss = ensemble_loss(params, X[idx], y[idx])
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if log_every and step % log_every == 0:
            print(f"step {step}/{steps}: loss={float(losses[-1]):.4f}")
    for v in params.values():
        v.requires_grad_(False)
    return [float(v) for v in losses]


def fold(params: dict[str, torch.Tensor], mu: np.ndarray, sd: np.ndarray) -> dict[str, np.ndarray]:
    """The ensemble on raw embeddings: the standardization folded into the
    first layer."""
    w1 = params["w1"].detach().cpu().numpy()
    return {
        "w1": (w1 / sd[None, :, None]).astype(np.float32),
        "b1": (params["b1"].detach().cpu().numpy() - np.einsum("d,edh->eh", mu / sd, w1)
               ).astype(np.float32),
        "w2": params["w2"].detach().cpu().numpy().astype(np.float32),
        "b2": params["b2"].detach().cpu().numpy().astype(np.float32),
    }


def validate(arrays: dict[str, np.ndarray], X: np.ndarray, y: np.ndarray, device) -> tuple[float, float]:
    """(accuracy, AUC) of the folded ensemble through SynScore's forward."""
    p = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    probs = ensemble_forward(p, torch.as_tensor(X, device=device)).cpu().numpy()
    acc = float(((probs >= 0.5).astype(int) == y).mean())
    order = np.argsort(probs)
    ranks = np.empty(len(probs))
    ranks[order] = np.arange(1, len(probs) + 1)
    pos = y == 1
    auc = (ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2) / max(pos.sum() * (~pos).sum(), 1)
    return acc, float(auc)


def main(argv: list[str] | None = None) -> dict[str, np.ndarray]:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(device)
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out_path = kv.get("out", "syn_score.npz")
    n = int(kv.get("n", 20000))
    steps = int(kv.get("steps", 3000))
    E = int(kv.get("n_models", 100))
    seed = int(kv.get("seed", 0))
    lr = float(kv.get("lr", 3e-3))

    data = prepare(n, seed, E)
    print(f"labeled {n} compositions: {data['ytr'].mean():.3f} positive (train)")
    generator = torch.Generator(device=device).manual_seed(seed)
    params = init_params(E, generator, device)
    train_ensemble(params, data["Xtr"], data["ytr"], data["boots"], steps, lr, generator,
                   log_every=max(steps // 10, 1))
    arrays = fold(params, data["mu"], data["sd"])
    acc, auc = validate(arrays, data["Xva_raw"], data["yva"], device)
    print(f"validation: acc={acc:.4f} auc={auc:.4f} (n={len(data['yva'])})")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **arrays)
    with open(os.path.splitext(out_path)[0] + ".meta.txt", "w") as fh:
        fh.write(f"val_acc={acc:.5f}\nval_auc={auc:.5f}\nn_models={E}\nsteps={steps}\n"
                 f"n_train={len(data['Xtr'])}\n")
    print(f"saved ensemble to {out_path}")
    return arrays


if __name__ == "__main__":
    main()
