"""Supervised trainer of the GNN property predictors, MSE regression
(``matinvent_tpu/parallel/train_predictor.py``).

Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) after a clip of the
gradients' global norm written as optax's ``clip_by_global_norm``: where the
norm is not below ``grad_clip``, each gradient becomes ``g / norm *
grad_clip`` (``torch.nn.utils.clip_grad_norm_`` scales by ``grad_clip /
(norm + 1e-6)`` instead). The edge branch trains on the plain PyTorch path.
"""
from __future__ import annotations

import logging
from typing import Iterator, Sequence

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.models.batch import CrystalBatch


def labeled_batches(
    structures: Sequence[Structure],
    labels: np.ndarray,
    batch_size: int,
    max_atoms: int,
    rng: np.random.Generator,
) -> Iterator[tuple[CrystalBatch, torch.Tensor]]:
    """Endless (CPU batch, f32 labels) pairs: each pass a new permutation
    of the usable pairs (at most ``max_atoms`` atoms, a finite label) from
    ``rng``, cut into full batches, as the JAX package draws them."""
    pairs = [
        (s, y)
        for s, y in zip(structures, labels)
        if s.num_atoms <= max_atoms and np.isfinite(y)
    ]
    if not pairs:
        raise ValueError("no usable (structure, label) pairs")
    n = len(pairs)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            chunk = [pairs[j] for j in order[i : i + batch_size]]
            batch = CrystalBatch.from_lists(
                [s.species for s, _ in chunk],
                [s.frac_coords for s, _ in chunk],
                [s.lattice for s, _ in chunk],
                max_atoms=max_atoms,
            )
            y = torch.tensor(np.asarray([v for _, v in chunk], dtype=np.float32))
            yield batch, y


def clip_by_global_norm_(params: Sequence[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


class PredictorTrainer:
    """MSE training of a ``PropertyGNN``'s module, in place."""

    def __init__(self, gnn, lr: float = 1e-3, grad_clip: float = 1.0):
        self.gnn = gnn
        self.lr = lr
        self.grad_clip = grad_clip

    def optimizer(self) -> torch.optim.Adam:
        return torch.optim.Adam(self.gnn.net.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

    def step(self, optimizer: torch.optim.Optimizer, batch: CrystalBatch, y: torch.Tensor) -> torch.Tensor:
        """One clipped Adam step on ``(batch, y)``; the loss before it. The
        clipped gradients stay in the parameters' ``.grad``."""
        dev = self.gnn.device
        optimizer.zero_grad(set_to_none=True)
        pred = self.gnn.forward(batch.to(dev))
        loss = torch.mean((pred - y.to(dev)) ** 2)
        loss.backward()
        clip_by_global_norm_(list(self.gnn.net.parameters()), self.grad_clip)
        optimizer.step()
        return loss.detach()

    def train(self, batches, num_steps: int, log_every: int = 100) -> list[float]:
        """``num_steps`` steps with a fresh Adam; the losses of the first
        step and of every ``log_every``-th."""
        opt = self.optimizer()
        history = []
        for i in range(num_steps):
            batch, y = next(batches)
            loss = self.step(opt, batch, y)
            if (i + 1) % log_every == 0 or i == 0:
                history.append(float(loss))
                logging.info(f"predictor step {i + 1}/{num_steps}: mse={float(loss):.5f}")
        return history
