"""Pretraining of a diffusion model's score net from scratch
(``matinvent_tpu/parallel/pretrain.py``), for both families.

``structures_to_batches`` shuffles a structure dataset with a numpy
``Generator`` and pads it into full batches, the same batches as the JAX
package for the same generator. ``PretrainTrainer`` runs the family's
``training_loss`` (uniform random times; for MatterGen with conditions,
classifier-free condition dropout) on the plain net, which trains as
JAX's XLA net does: the edge kernel has no backward, so pretraining
launches none.

The optimizer is optax's, written in PyTorch: ``clip_by_global_norm
(grad_clip)`` (each gradient ``g / norm * grad_clip`` where the norm is
not below ``grad_clip``), then Adam (b1 0.9, b2 0.999, eps 1e-8), or AdamW
with decoupled decay on every parameter when ``weight_decay > 0``. With
``total_steps`` the learning rate follows
``warmup_cosine_decay_schedule(0, lr, min(warmup_steps, total_steps // 10
+ 1), total_steps, 0.02 lr)`` in f32, as optax evaluates it (within one
f32 ulp of ``lr``: XLA's f32 cosine is not numpy's); step ``i``
(from 0) uses its value at ``i``. The EMA of the weights is ``e d + p (1 -
d)`` after each step.
"""
from __future__ import annotations

import logging
from typing import Iterator, Sequence

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.diffcsp import DiffCSPDiffusion
from matinvent_tpu_torch.parallel.train_predictor import clip_by_global_norm_


def structures_to_batches(
    structures: Sequence[Structure],
    batch_size: int,
    max_atoms: int,
    rng: np.random.Generator,
    drop_oversize: bool = True,
) -> Iterator[CrystalBatch]:
    """Endless CPU batches: each pass a new permutation of the usable
    structures (1 to ``max_atoms`` atoms) from ``rng``, cut into full
    batches."""
    usable = [
        s for s in structures
        if (not drop_oversize or s.num_atoms <= max_atoms) and s.num_atoms >= 1
    ]
    if not usable:
        raise ValueError("no structures fit max_atoms")
    n = len(usable)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            chunk = [usable[j] for j in order[i: i + batch_size]]
            yield CrystalBatch.from_lists(
                [s.species for s in chunk],
                [s.frac_coords for s in chunk],
                [s.lattice for s in chunk],
                max_atoms=max_atoms,
            )


def warmup_cosine_lr(count: int, lr: float, warmup_steps: int, total_steps: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup_steps,
    total_steps, 0.02 lr)`` at ``count``, in f32 as optax computes it."""
    f32 = np.float32
    if count < warmup_steps:
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1.0) - c / f32(warmup_steps)
        return float(f32(0.0 - lr) * frac + f32(lr))
    return cosine_decay_lr(count - warmup_steps, lr, total_steps - warmup_steps,
                           (lr * 0.02) / lr)


def cosine_decay_lr(count: int, lr: float, decay_steps: int, alpha: float) -> float:
    """optax's ``cosine_decay_schedule(lr, decay_steps, alpha)`` at
    ``count``, in f32 as optax computes it."""
    f32 = np.float32
    c = f32(min(count, decay_steps))
    # the f32 cosine rounded from f64: the nearest to XLA's of numpy's and torch's
    cosine = f32(0.5) * (f32(1.0) + f32(np.cos(np.float64(f32(np.pi) * c / f32(decay_steps)))))
    return float(f32(lr) * (f32(1.0 - alpha) * cosine + f32(alpha)))


def adam_optimizer(params, lr: float, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8), or ``adamw`` with
    decoupled decay on every parameter when ``weight_decay > 0``."""
    if weight_decay > 0:
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class PretrainTrainer:
    """Trains ``diffusion``'s parameters in place."""

    def __init__(
        self,
        diffusion,
        lr: float = 1e-3,
        grad_clip: float = 0.5,
        weight_decay: float = 0.0,
        total_steps: int | None = None,
        warmup_steps: int = 200,
        cond_dropout: float = 0.1,
        ema_decay: float | None = None,
    ):
        self.diffusion = diffusion
        self.lr = lr
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.total_steps = total_steps
        self.warmup_steps = min(warmup_steps, total_steps // 10 + 1) if total_steps else 0
        if total_steps and total_steps <= self.warmup_steps:
            raise ValueError("total_steps must exceed the warmup")
        self.cond_dropout = cond_dropout
        self.ema_decay = ema_decay

    def learning_rate(self, count: int) -> float:
        """The learning rate of step ``count`` (from 0)."""
        if not self.total_steps:
            return self.lr
        return warmup_cosine_lr(count, self.lr, self.warmup_steps, self.total_steps)

    def optimizer(self) -> torch.optim.Optimizer:
        return adam_optimizer(self.diffusion.parameters(), self.learning_rate(0), self.weight_decay)

    def loss(self, batch: CrystalBatch, conditions=None, generator=None, draws=None,
             t=None, cond_mask=None):
        """(loss, metrics) of the family's pretraining objective; ``draws``,
        ``t`` (MatterGen: times in (0, 1]; DiffCSP: integer times 1..T) and
        ``cond_mask`` replace the draws from ``generator``."""
        d = self.diffusion
        if isinstance(d, DiffCSPDiffusion):
            if conditions:
                raise ValueError("DiffCSP is unconditional; got conditions")
            t_index = None if t is None else d.config.timesteps - torch.as_tensor(t)
            return d.training_loss(batch, draws, generator, t_index)
        return d.training_loss(batch, draws, generator, conditions, self.cond_dropout,
                               t=t, cond_mask=cond_mask)

    def step(self, optimizer: torch.optim.Optimizer, count: int, batch: CrystalBatch,
             conditions=None, generator=None, **given) -> dict[str, torch.Tensor]:
        """One clipped optimizer step (step ``count`` of the schedule); the
        loss's metrics before it and the gradients' global norm before the
        clip (``grad_norm``), as device tensors."""
        dev = next(self.diffusion.parameters()).device
        optimizer.zero_grad(set_to_none=True)
        if conditions:
            conditions = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                          for k, v in conditions.items()}
        loss, metrics = self.loss(batch.to(dev), conditions, generator, **given)
        loss.backward()
        params = [p for p in self.diffusion.parameters() if p.grad is not None]
        grad_norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in params))
        clip_by_global_norm_(params, self.grad_clip)
        for group in optimizer.param_groups:
            group["lr"] = self.learning_rate(count)
        optimizer.step()
        return {**{k: v.detach() for k, v in metrics.items()}, "grad_norm": grad_norm.detach()}

    def ema_update(self, ema: dict[str, torch.Tensor]) -> None:
        d = self.ema_decay
        with torch.no_grad():
            for name, p in self.diffusion.named_parameters():
                ema[name] = ema[name] * d + p * (1.0 - d)

    def weights(self, ema: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        """The module's state dict, its parameters replaced by ``ema``."""
        sd = {k: v.detach().clone() for k, v in self.diffusion.state_dict().items()}
        if ema is not None:
            sd.update({k: v.clone() for k, v in ema.items()})
        return sd

    def train(
        self,
        batches: Iterator,
        num_steps: int,
        generator: torch.Generator | None = None,
        log_every: int = 100,
        snapshot_every: int | None = None,
        snapshot_cb=None,
    ) -> tuple[dict[str, torch.Tensor], list[dict[str, float]]]:
        """``num_steps`` steps with a fresh optimizer. Batches are
        ``CrystalBatch`` or ``(CrystalBatch, conditions)`` (conditional
        MatterGen). ``snapshot_cb(step, weights, ema_weights_or_None)``
        runs every ``snapshot_every`` steps and at the end. Returns the
        final weights (the EMA's when ``ema_decay`` is set) and the metrics
        of step 1 and of every ``log_every``-th step."""
        opt = self.optimizer()
        ema = None
        if self.ema_decay is not None:
            ema = {k: p.detach().clone() for k, p in self.diffusion.named_parameters()}
        history = []
        for i in range(num_steps):
            item = next(batches)
            batch, conditions = item if isinstance(item, tuple) else (item, None)
            metrics = self.step(opt, i, batch, conditions, generator)
            if ema is not None:
                self.ema_update(ema)
            if (i + 1) % log_every == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items()}
                history.append(m)
                logging.info(f"pretrain step {i + 1}/{num_steps}: "
                             + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
            if snapshot_cb is not None and snapshot_every and (
                (i + 1) % snapshot_every == 0 or i + 1 == num_steps
            ):
                snapshot_cb(i + 1, self.weights(), None if ema is None else self.weights(ema))
        return self.weights(ema), history
