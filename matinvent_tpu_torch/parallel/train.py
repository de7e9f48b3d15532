"""Reward-weighted fine-tune driver (``matinvent_tpu/parallel/train.py:29 FinetuneStep``).

One RL iteration's fine-tune: a fresh Adam (optax's defaults: b1 0.9, b2
0.999, eps 1e-8), ``epochs`` passes over the same batch, each pass a loop
over ``timesteps // accum_steps`` chunks of consecutive grid indices with
one optimizer step per chunk. A chunk whose loss is not finite leaves the
parameters and the optimizer state, step count included, as they were.
"""
from __future__ import annotations

from typing import Callable

import torch

from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.mattergen.diffusion import MatterGenDiffusion, NoiseDraws

# chunk index -> the chunk's draws (leading axis accum_steps); None draws
# from the generator instead
ChunkDraws = Callable[[int], NoiseDraws]


class FinetuneStep:
    """Reward-weighted fine-tune of an agent against a frozen prior."""

    def __init__(
        self,
        timesteps: int,
        lr: float = 1e-4,
        accum_steps: int = 50,
        sigma_kl: float = 0.025,
        epochs: int = 3,
    ):
        self.lr = lr
        self.timesteps = timesteps
        self.accum_steps = accum_steps
        self.sigma_kl = sigma_kl
        self.epochs = epochs
        if self.timesteps % self.accum_steps:
            raise ValueError("timesteps must be divisible by accum_steps")
        self.n_chunks = self.timesteps // self.accum_steps

    def optimizer(self, agent: MatterGenDiffusion) -> torch.optim.Adam:
        return torch.optim.Adam(agent.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

    def epoch(
        self,
        agent: MatterGenDiffusion,
        optimizer: torch.optim.Optimizer,
        prior: MatterGenDiffusion,
        batch: CrystalBatch,
        rewards: torch.Tensor,
        generator: torch.Generator | None = None,
        draws: ChunkDraws | None = None,
        conditions=None,
    ) -> dict[str, float]:
        """One pass over the chunks; updates ``agent`` in place and returns
        the epoch's ``loss`` (mean chunk loss), ``loss_diff`` and ``loss_kl``
        (per crystal and timestep)."""
        dev = batch.frac_coords.device
        losses, diff_sum, kl_sum = [], 0.0, 0.0
        for c in range(self.n_chunks):
            t_idx = c * self.accum_steps + torch.arange(self.accum_steps, device=dev)
            optimizer.zero_grad(set_to_none=True)
            loss, (ld, lk) = agent.rl_chunk_loss(
                prior, batch, rewards, t_idx, self.sigma_kl,
                draws=None if draws is None else draws(c), generator=generator,
                conditions=conditions,
            )
            # the NaN guard: no step, so Adam's moments and count stay too
            if torch.isfinite(loss):
                loss.backward()
                optimizer.step()
            losses.append(loss.detach())
            diff_sum = diff_sum + ld.detach()
            kl_sum = kl_sum + lk.detach()
        B = max(int(rewards.shape[0]), 1)
        return dict(
            loss=float(torch.stack(losses).mean()),
            loss_diff=float(diff_sum) / (self.timesteps * B),
            loss_kl=float(kl_sum) / (self.timesteps * B),
        )

    def run(
        self,
        agent: MatterGenDiffusion,
        prior: MatterGenDiffusion,
        batch: CrystalBatch,
        rewards: torch.Tensor,
        generator: torch.Generator | None = None,
        conditions=None,
    ) -> list[dict[str, float]]:
        """The whole fine-tune of one RL iteration, in place: a fresh Adam,
        then ``epochs`` epochs over the same batch, each drawing its noise
        from ``generator``. Returns each epoch's metrics."""
        opt = self.optimizer(agent)
        return [
            self.epoch(agent, opt, prior, batch, rewards, generator, conditions=conditions)
            for _ in range(self.epochs)
        ]
