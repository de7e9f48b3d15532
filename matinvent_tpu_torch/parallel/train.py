"""The fine-tune steps (``matinvent_tpu/parallel/train.py``).

``FinetuneStep`` is the reward-weighted fine-tune of either family: a fresh
Adam each RL iteration (optax's defaults: b1 0.9, b2 0.999, eps 1e-8),
``epochs`` passes over the same batch, each a loop over ``timesteps //
accum_steps`` chunks of consecutive time indices with one optimizer step per
chunk, through the agent's ``rl_chunk_loss``. A chunk whose loss is not
finite leaves the parameters and the optimizer state, step count included,
as they were.

``DDPOFinetuneStep`` (DiffCSP) and ``MatterGenDDPOStep`` are the
PPO-clipped policy gradient over a recorded sampling trajectory: the loss
``-E[min(r A, clip(r, 1 - eps, 1 + eps) A)]`` with ``r = exp(clip(new_lp -
old_lp, -20, 20))`` and standardized advantages, the deterministic last
transition masked out, one optimizer step per chunk of ``chunk``
transitions, ``epochs`` passes with one fresh optimizer per RL iteration:
optax's ``clip_by_global_norm`` (``g / norm * max`` where the norm is not
below ``max``) then Adam. The replay takes the recorded batch's selected
rows (``rows``, the scored crystals) and sends the chunk's steps through one
batched forward, as JAX's ``vmap`` does; at the recording parameters the
ratios are 1 up to the summation order the products take at the replay's
shapes.

Data parallel (``mesh``, ``parallel/mesh.py``): each rank holds its
contiguous block of the batch's rows (of the trajectory's, for DDPO), of
one size on every rank (``Mesh.rows`` splits evenly), and the replicated
parameters. What JAX's sharded ``jit`` derives, the steps do
by hand: every loss is divided by the global row count, so that the sum of
the ranks' gradients (one all-reduce before the step) is the global
gradient; the gradient clip runs after that reduce, on the global gradient;
the NaN guard, the reported losses, the ratio statistics and the
advantages' mean and std are over all rows. The fine-tune's draws are the
whole batch's, of which each rank keeps its rows, as the sampler's are.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.parallel.mesh import Mesh
from matinvent_tpu_torch.parallel.train_predictor import clip_by_global_norm_

# chunk index -> the chunk's draws (the family's ``NoiseDraws``, leading
# axis accum_steps); None draws from the generator instead
ChunkDraws = Callable[[int], tuple]


def adam(module: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults over ``module``'s parameters."""
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


class FinetuneStep:
    """Reward-weighted fine-tune of an agent against a frozen prior; the
    agent is a ``MatterGenDiffusion`` or a ``DiffCSPDiffusion``."""

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

    def optimizer(self, agent: nn.Module) -> torch.optim.Adam:
        return adam(agent, self.lr)

    def epoch(
        self,
        agent: nn.Module,
        optimizer: torch.optim.Optimizer,
        prior: nn.Module,
        batch: CrystalBatch,
        rewards: torch.Tensor,
        generator: torch.Generator | None = None,
        draws: ChunkDraws | None = None,
        conditions=None,
        mesh: Mesh | None = None,
    ) -> dict[str, float]:
        """One pass over the chunks; updates ``agent`` in place and returns
        the epoch's ``loss`` (mean chunk loss), ``loss_diff`` and ``loss_kl``
        (per crystal and timestep). Under ``mesh`` the batch, rewards and
        conditions are this rank's rows, and ``draws`` the whole batch's."""
        dev = batch.frac_coords.device
        B = int(rewards.shape[0])
        total = B if mesh is None else B * mesh.size
        rows = None if mesh is None else mesh.rows(total)
        params = [p for p in agent.parameters() if p.requires_grad]
        losses, diff_sum, kl_sum = [], 0.0, 0.0
        for c in range(self.n_chunks):
            t_idx = c * self.accum_steps + torch.arange(self.accum_steps, device=dev)
            d = None if draws is None else draws(c)
            if mesh is not None:
                if d is None:
                    d = agent.rl_draws(self.accum_steps, total, batch.max_atoms, generator, dev)
                d = type(d)(*(x[:, rows] for x in d))
            optimizer.zero_grad(set_to_none=True)
            loss, (ld, lk) = agent.rl_chunk_loss(
                prior, batch, rewards, t_idx, self.sigma_kl,
                draws=d, generator=generator, conditions=conditions,
            )
            if mesh is not None:
                loss = loss * (B / total)
            seen = loss.detach() if mesh is None else mesh.all_reduce_(loss.detach().clone())
            # the NaN guard: no step, so Adam's moments and count stay too
            if torch.isfinite(seen):
                loss.backward()
                if mesh is not None:
                    mesh.all_reduce_grads_(params)
                optimizer.step()
            losses.append(seen)
            diff_sum = diff_sum + ld.detach()
            kl_sum = kl_sum + lk.detach()
        if mesh is not None:
            diff_sum, kl_sum = mesh.all_reduce_(torch.stack([diff_sum, kl_sum]))
        total = max(total, 1)
        return dict(
            loss=float(torch.stack(losses).mean()),
            loss_diff=float(diff_sum) / (self.timesteps * total),
            loss_kl=float(kl_sum) / (self.timesteps * total),
        )

    def run(
        self,
        agent: nn.Module,
        prior: nn.Module,
        batch: CrystalBatch,
        rewards: torch.Tensor,
        generator: torch.Generator | None = None,
        conditions=None,
        mesh: Mesh | None = None,
    ) -> list[dict[str, float]]:
        """The whole fine-tune of one RL iteration, in place: a fresh Adam,
        then ``epochs`` epochs over the same batch, each drawing its noise
        from ``generator``. Returns each epoch's metrics."""
        opt = self.optimizer(agent)
        return [
            self.epoch(agent, opt, prior, batch, rewards, generator, conditions=conditions,
                       mesh=mesh)
            for _ in range(self.epochs)
        ]


def _ratio_sums(ratio: torch.Tensor, w: torch.Tensor, clip_eps: float):
    """This rank's sums of the importance-ratio statistics over the valid
    transitions of one chunk, ``[sum ratio, count, clipped count]``, and
    its largest ratio: ``ratio`` ``[C, B]``, ``w`` the ``[C, 1]`` validity
    weight."""
    wb = torch.broadcast_to(w, ratio.shape)
    sums = torch.stack([torch.sum(ratio * wb), torch.sum(wb),
                        torch.sum((torch.abs(ratio - 1.0) > clip_eps) * wb)])
    return sums, torch.max(ratio * wb)


def _ratio_stats(sums: torch.Tensor, top: torch.Tensor) -> dict[str, torch.Tensor]:
    """The statistics from ``_ratio_sums`` (summed, and the largest, over
    the ranks under a mesh). At the recording weights a correct replay
    gives ratios of 1."""
    n = torch.clamp(sums[1], min=1.0)
    return dict(ratio_mean=sums[0] / n, ratio_max=top, clip_frac=sums[2] / n)


def _flat_rows(traj, keys, sl: slice, rows) -> dict[str, torch.Tensor]:
    """The recorded steps ``sl`` of the rows ``rows``, steps-major and
    flattened to ``[C * B, ...]`` (one row per crystal and step)."""
    out = {}
    for k in keys:
        x = traj[k][sl][:, rows]
        out[k] = x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
    return out


class DDPOFinetuneStep:
    """DDPO over ``DiffCSPDiffusion.sample(record_traj=True)`` trajectories
    (``forward_logprob``'s lattice, type and coordinate log-probs)."""

    step_key = "timestep"
    lp_keys = ("log_prob_l", "log_prob_t", "log_prob_x")

    def __init__(
        self,
        lr: float = 1e-5,
        clip_eps: float = 0.2,
        chunk: int = 50,
        step_lr: float = 5e-6,
        adv_norm: bool = True,
        epochs: int = 1,
        max_grad_norm: float = 1.0,
    ):
        self.lr = lr
        self.clip_eps = clip_eps
        self.chunk = chunk
        self.step_lr = step_lr
        self.adv_norm = adv_norm
        self.epochs = epochs
        self.max_grad_norm = max_grad_norm
        self.last_stats: dict[str, float] = {}
        self.epoch_stats: list[dict[str, float]] = []

    def optimizer(self, agent: nn.Module) -> torch.optim.Adam:
        return adam(agent, self.lr)

    # ---------------------------------------------------- the family's replay
    def new_logprob(self, agent, traj, sl: slice, rows, num_atoms, mask, **replay) -> torch.Tensor:
        """``[C, B]`` log-probs of the recorded steps ``sl`` of the rows
        ``rows`` under ``agent``, through one batched forward."""
        C, B = sl.stop - sl.start, len(rows)
        state = _flat_rows(traj, ("frac_coords", "lattices", "atom_types", "frac_coords_mid",
                                  "next_frac_coords", "next_lattices", "next_atom_types"), sl, rows)
        state["timesteps"] = traj["timestep"][sl].repeat_interleave(B)
        state["num_atoms"] = num_atoms[rows].repeat(C)
        lp_l, lp_t, lp_x, _ = agent.forward_logprob(state, mask[rows].repeat(C, 1), self.step_lr)
        return (lp_l + lp_t + lp_x).reshape(C, B)

    def valid(self, agent, steps: torch.Tensor) -> torch.Tensor:
        """Weight of each recorded step: the t = 1 transition has zero
        posterior and corrector stds, so its log-probs are degenerate."""
        return (steps > 1).to(torch.float32)

    # ------------------------------------------------------------ the update
    def chunk_loss(self, agent, traj, c: int, rows, num_atoms, mask, advantages,
                   total: int | None = None, **replay):
        """(PPO loss of chunk ``c``, this rank's ``_ratio_sums``); with
        ``total`` (under a mesh) the loss is this rank's share of the mean
        over all ``total`` rows."""
        sl = slice(c * self.chunk, (c + 1) * self.chunk)
        new_lp = self.new_logprob(agent, traj, sl, rows, num_atoms, mask, **replay)  # [C, B]
        old_lp = sum(traj[k][sl][:, rows] for k in self.lp_keys)
        steps = traj[self.step_key][sl]
        ratio = torch.exp(torch.clamp(new_lp - old_lp, -20.0, 20.0))
        clipped = torch.clamp(ratio, 1.0 - self.clip_eps, 1.0 + self.clip_eps)
        obj = torch.minimum(ratio * advantages, clipped * advantages)
        w = self.valid(agent, steps)[:, None]
        n_rows = obj.shape[1] if total is None else total
        loss = -torch.sum(obj * w) / torch.clamp(torch.sum(w) * n_rows, min=1.0)
        return loss, _ratio_sums(ratio.detach(), w, self.clip_eps)

    def _n_chunks(self, traj) -> int:
        T = traj[self.step_key].shape[0]
        if T % self.chunk:
            raise ValueError(
                f"trajectory length {T} not divisible by chunk={self.chunk}; "
                "the trailing transitions would be silently dropped"
            )
        return T // self.chunk

    @staticmethod
    def _epoch_stats(losses, stats) -> tuple[float, dict[str, float]]:
        agg = dict(
            ratio_mean=float(torch.stack([s["ratio_mean"] for s in stats]).mean()),
            ratio_max=float(torch.stack([s["ratio_max"] for s in stats]).max()),
            clip_frac=float(torch.stack([s["clip_frac"] for s in stats]).mean()),
        )
        return float(torch.stack(losses).mean()), agg

    def update(self, agent, optimizer, traj, num_atoms, mask, advantages, rows=None,
               mesh: Mesh | None = None, **replay) -> tuple[float, dict[str, float]]:
        """One PPO pass over the trajectory's chunks, one optimizer step per
        chunk: (mean chunk loss, ratio statistics: the chunks' mean ratio,
        their largest ratio and mean clipped fraction). Under ``mesh`` the
        trajectory, ``rows`` and ``advantages`` are this rank's, and the
        gradients are summed over the ranks before the clip and the step,
        in one collective with the loss and the ratio sums (a second takes
        the largest ratio)."""
        rows = torch.arange(num_atoms.shape[0], device=num_atoms.device) if rows is None else rows
        total = None if mesh is None else len(rows) * mesh.size
        losses, stats = [], []
        params = [p for p in agent.parameters() if p.requires_grad]
        for c in range(self._n_chunks(traj)):
            optimizer.zero_grad(set_to_none=True)
            loss, (sums, top) = self.chunk_loss(agent, traj, c, rows, num_atoms, mask,
                                                advantages, total, **replay)
            loss.backward()
            seen = torch.cat([loss.detach().reshape(1), sums])
            if mesh is not None:
                seen = mesh.all_reduce_grads_(params, extra=seen)
                top = mesh.all_reduce_(top.clone(), "max")
            clip_by_global_norm_(params, self.max_grad_norm)
            optimizer.step()
            losses.append(seen[0])
            stats.append(_ratio_stats(seen[1:], top))
        return self._epoch_stats(losses, stats)

    @torch.no_grad()
    def replay_stats(self, agent, traj, num_atoms, mask, rows=None, mesh: Mesh | None = None,
                     **replay) -> dict[str, float]:
        """The ratio statistics of the whole trajectory (every rank's under
        ``mesh``) at ``agent``'s current parameters, without an update (the
        behaviour policy's own replay gives a mean of 1 and no clipped
        ratio)."""
        rows = torch.arange(num_atoms.shape[0], device=num_atoms.device) if rows is None else rows
        zeros = torch.zeros(len(rows), device=num_atoms.device)
        total = None if mesh is None else len(rows) * mesh.size
        losses, stats = [], []
        for c in range(self._n_chunks(traj)):
            loss, (sums, top) = self.chunk_loss(agent, traj, c, rows, num_atoms, mask, zeros,
                                                total, **replay)
            if mesh is not None:
                sums, top = mesh.all_reduce_(sums), mesh.all_reduce_(top.clone(), "max")
            losses.append(loss)
            stats.append(_ratio_stats(sums, top))
        return self._epoch_stats(losses, stats)[1]

    def advantages(self, rewards: torch.Tensor, baseline=None,
                   mesh: Mesh | None = None) -> torch.Tensor:
        """Rewards less the baseline (their mean by default), standardized
        with ``adv_norm``: centred again, then over the population std + 1e-6.
        Under ``mesh`` ``rewards`` are this rank's: the statistics are taken
        over every rank's, and this rank's advantages returned."""
        rewards = rewards.to(torch.float32)
        if mesh is not None:
            n = rewards.shape[0]
            full = self.advantages(mesh.all_gather_rows(rewards), baseline)
            return full[mesh.rank * n: (mesh.rank + 1) * n]
        adv = rewards - (baseline if baseline is not None else torch.mean(rewards))
        if self.adv_norm:
            adv = adv - torch.mean(adv)
            adv = adv / (torch.std(adv, correction=0) + 1e-6)
        return adv

    def run(self, agent, traj, num_atoms, mask, rewards, baseline=None, rows=None,
            mesh: Mesh | None = None, **replay) -> float:
        """The DDPO fine-tune of one RL iteration, in place: a fresh
        optimizer, then ``epochs`` PPO passes. ``rewards`` are those of the
        rows ``rows`` of the recorded batch (all rows by default; under
        ``mesh`` this rank's block of it). Keeps each pass's ratio
        statistics (``epoch_stats``) and the last pass's (``last_stats``,
        the pipeline's ``ddpo_*`` columns); returns the last pass's loss."""
        adv = self.advantages(rewards, baseline, mesh)
        opt = self.optimizer(agent)
        loss, self.epoch_stats = 0.0, []
        for _ in range(max(self.epochs, 1)):
            loss, stats = self.update(agent, opt, traj, num_atoms, mask, adv, rows, mesh,
                                      **replay)
            self.epoch_stats.append(stats)
        self.last_stats = self.epoch_stats[-1]
        return loss


class MatterGenDDPOStep(DDPOFinetuneStep):
    """DDPO over ``MatterGenDiffusion.sample(record_traj=True)``
    trajectories (cell, coordinate and D3PM type log-probs), replayed under
    the conditioning, guidance and fixed types they were sampled with."""

    step_key = "step"
    lp_keys = ("log_prob_cell", "log_prob_types", "log_prob_pos")

    def __init__(self, lr: float = 3e-6, clip_eps: float = 0.2, chunk: int = 50,
                 adv_norm: bool = True, epochs: int = 1, max_grad_norm: float = 1.0):
        super().__init__(lr=lr, clip_eps=clip_eps, chunk=chunk, adv_norm=adv_norm,
                         epochs=epochs, max_grad_norm=max_grad_norm)
        self._tables = None

    def new_logprob(self, agent, traj, sl, rows, num_atoms, mask, conditions=None,
                    guidance: float = 0.0, fixed_types=None):
        C, B = sl.stop - sl.start, len(rows)
        state = _flat_rows(traj, ("cell_in", "pos_in", "types_in", "pos_mid", "cell", "pos",
                                  "types"), sl, rows)
        state["step"] = traj["step"][sl].repeat_interleave(B)
        if self._tables is None or self._tables[0] is not agent:
            self._tables = (agent, agent._step_tables())
        cond = None if conditions is None else {k: v[rows].repeat(C) for k, v in conditions.items()}
        lp_cell, lp_types, lp_pos, _ = agent.forward_logprob(
            state, num_atoms[rows].repeat(C), mask[rows].repeat(C, 1), self._tables[1],
            conditions=cond, guidance=guidance,
            fixed_types=None if fixed_types is None else fixed_types[rows].repeat(C, 1),
        )
        return (lp_cell + lp_types + lp_pos).reshape(C, B)

    def valid(self, agent, steps):
        # the last grid step is deterministic (no noise, argmax types)
        return (steps < agent.config.timesteps - 1).to(torch.float32)
