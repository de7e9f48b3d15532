"""MatterGen-class joint diffusion (``matinvent_tpu/models/mattergen/diffusion.py``).

``sample`` and ``sample_bucketed`` run the predictor-corrector ancestral
sampler over the descending grid ``linspace(1, 1/N, N)``: a Langevin
corrector on the coords, then a VP ancestral step on the cell, a VE step on
the wrapped coords and a D3PM ancestral draw of the types. The JAX
``lax.scan`` is a Python loop here, and ``jax.random.categorical`` is
``argmax(logits + gumbel)``.

Every random draw comes from a ``NoiseSource``: by default
``GeneratorNoise`` over an explicit ``torch.Generator``; a test can hand
``ArrayNoise`` the exact draws of another implementation instead.

On the card the sampling net sends each layer's fc edge branch through the
hand-written kernel (``ops.fused_edge``) unless ``fused_edge=False`` is
passed. This differs from the JAX package, whose config key
``fused_edge_sampling`` defaults to false; the port has no such key (the
config reader drops it).

``sample(record_traj=True)`` records each transition (the state entering
the step, the post-corrector coords, the realized next state) and the
log-probs of its draws, on the plain net whatever ``fused_edge`` says:
``forward_logprob`` recomputes them for DDPO (``parallel/train.py``) and
must differentiate, and the kernel's rounding would move the importance
ratios off 1. The recorder wraps the post-corrector coords into [0, 1)
before the predictor, so the replay of the recorded state repeats its
arithmetic exactly (the JAX recorder keeps them unwrapped, which moves the
replayed log-probs by rounding). ``fixed_types`` holds the types through
the chain (CSP mode; the sampler does not offer it yet).

The training half (``add_noise``, ``sample_losses``, ``kl_reg``,
``rl_timestep_loss``, ``rl_chunk_loss``) always runs the f32 net on the
plain edge path, as the JAX package trains its XLA net: the edge kernel has
no backward. ``rl_chunk_loss`` sends its timesteps x crystals through one
batched forward, as JAX's ``vmap`` does; the frozen prior's predictions come
from a second module under ``torch.no_grad()`` (JAX's ``stop_gradient``).
``add_noise`` takes its draws as ``NoiseDraws`` (JAX's exact draws in the
tests) or makes them from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple, Sequence

import torch
from torch import nn

from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.diffcsp import norm_logpdf, sinusoidal_time_embedding
from matinvent_tpu_torch.models.mattergen.corruption import (
    LatticeVPSDE,
    TypeD3PM,
    WrappedCoordVE,
)
from matinvent_tpu_torch.models.mattergen.score_net import MatterGenScoreNet
from matinvent_tpu_torch.ops.segment import graph_mean
from matinvent_tpu_torch.ops.wrapped_normal import log_prob_wrapped_normal

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MGNoised(NamedTuple):
    t: torch.Tensor  # [B] continuous time in (0, 1]
    time_emb: torch.Tensor  # [B, time_dim]
    atom_types_t: torch.Tensor  # [B, A] int (D3PM state)
    frac_coords_t: torch.Tensor  # [B, A, 3]
    lattice_t: torch.Tensor  # [B, 3, 3]


@dataclass(frozen=True)
class MatterGenConfig:
    """The JAX package's ``MatterGenConfig`` fields and defaults."""

    hidden_dim: int = 256
    num_layers: int = 6
    time_dim: int = 256
    num_freqs: int = 10
    timesteps: int = 1000
    max_atomic_num: int = 100
    d3pm_kind: str = "uniform"
    d3pm_hybrid_lambda: float = 0.01
    beta_min: float = 0.1
    beta_max: float = 20.0
    sigma_min: float = 0.005
    sigma_max: float = 0.5
    weight_cell: float = 1.0
    weight_pos: float = 0.1
    weight_types: float = 1.0
    n_corrector: int = 1
    corrector_snr: float = 0.2
    condition_fields: tuple = ()
    # ((field, mean, std), ...): conditions are standardized before embedding
    condition_stats: tuple = ()
    sample_clip: float | None = None
    # compute dtype of the score-net evals inside the sampling loop
    sample_dtype: str = "float32"
    # D3PM type-sampling temperature (1.0 = the exact posterior)
    type_temperature: float = 1.0
    edge_style: str = "fc"
    cutoff: float = 6.0
    max_neighbors: int = 20

    @classmethod
    def from_dict(cls, values: Mapping[str, Any]) -> "MatterGenConfig":
        """Config from a flat mapping; unknown keys are dropped, lists become
        tuples (as a YAML round trip gives them back)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in values.items() if k in names}
        for k in ("condition_fields", "condition_stats"):
            if isinstance(kw.get(k), list):
                kw[k] = tuple(tuple(e) if isinstance(e, list) else e for e in kw[k])
        return cls(**kw)


class MGTargets(NamedTuple):
    eps_cell: torch.Tensor  # [B, 3, 3]
    score_pos: torch.Tensor  # [B, A, 3] sigma-scaled wrapped-normal score
    x0_types: torch.Tensor  # [B, A] int ground-truth classes (0-based)


class NoiseDraws(NamedTuple):
    """The draws of ``add_noise``, with any leading axes before ``B``."""

    cell: torch.Tensor  # [..., B, 3, 3] standard normal
    pos: torch.Tensor  # [..., B, A, 3] standard normal
    gumbel: torch.Tensor  # [..., B, A, V] standard Gumbel (type draw)


def gumbel_like(
    shape, generator: torch.Generator, device: torch.device | str
) -> torch.Tensor:
    """Standard Gumbel draw ``-log(-log(u))`` of ``shape``."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def noise_draws(
    lead: tuple[int, ...], B: int, A: int, vocab: int, generator: torch.Generator,
    device: torch.device | str,
) -> NoiseDraws:
    """``add_noise``'s draws for ``lead + (B, ...)`` from ``generator``."""
    return NoiseDraws(
        torch.randn((*lead, B, 3, 3), generator=generator, device=device),
        torch.randn((*lead, B, A, 3), generator=generator, device=device),
        gumbel_like((*lead, B, A, vocab), generator, device),
    )


class StepDraws(NamedTuple):
    cell: torch.Tensor  # [B, 3, 3] standard normal (predictor, cell)
    pos: torch.Tensor  # [B, A, 3] standard normal (predictor, coords)
    gumbel: torch.Tensor  # [B, A, V] standard Gumbel (type draw)
    corr: torch.Tensor  # [n_corrector, B, A, 3] standard normal (corrector)


class NoiseSource:
    """Where the sampler's random draws come from."""

    def prior(self, B: int, A: int, vocab: int, device: torch.device):
        """(standard normal ``[B,3,3]``, uniform ``[B,A,3]``, integer
        ``[B,A]`` in ``[0, vocab)``) for the prior state."""
        raise NotImplementedError

    def step(
        self, i: int, B: int, A: int, vocab: int, n_corrector: int,
        device: torch.device,
    ) -> StepDraws:
        raise NotImplementedError


class GeneratorNoise(NoiseSource):
    """Draws from an explicit ``torch.Generator`` (on the sampling device)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def prior(self, B, A, vocab, device):
        g = self.generator
        return (
            torch.randn((B, 3, 3), generator=g, device=device),
            torch.rand((B, A, 3), generator=g, device=device),
            torch.randint(0, vocab, (B, A), generator=g, device=device),
        )

    def step(self, i, B, A, vocab, n_corrector, device):
        g = self.generator
        cell = torch.randn((B, 3, 3), generator=g, device=device)
        pos = torch.randn((B, A, 3), generator=g, device=device)
        gumbel = gumbel_like((B, A, vocab), g, device)
        corr = torch.randn((n_corrector, B, A, 3), generator=g, device=device)
        return StepDraws(cell, pos, gumbel, corr)


class ArrayNoise(NoiseSource):
    """Fixed draws: ``prior = (z_cell, u_pos, types)`` and per-step arrays
    ``cell [N,B,3,3]``, ``pos [N,B,A,3]``, ``gumbel [N,B,A,V]``,
    ``corr [N,n_corrector,B,A,3]`` (numpy or torch)."""

    def __init__(self, prior, cell, pos, gumbel, corr):
        self._prior = prior
        self._steps = (cell, pos, gumbel, corr)

    def prior(self, B, A, vocab, device):
        z, u, types = self._prior
        return (
            torch.as_tensor(z, dtype=torch.float32, device=device),
            torch.as_tensor(u, dtype=torch.float32, device=device),
            torch.as_tensor(types, dtype=torch.long, device=device),
        )

    def step(self, i, B, A, vocab, n_corrector, device):
        return StepDraws(
            *(torch.as_tensor(a[i], dtype=torch.float32, device=device) for a in self._steps)
        )


class MatterGenDiffusion(nn.Module):
    """The score net (``self.decoder``) and the sampler around it.

    The module's parameter names are the checkpoints' ``state_dict.npz``
    keys, so ``load_state_dict(npz, strict=True)`` loads one.
    """

    def __init__(
        self, config: MatterGenConfig | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        self.config = c = config or MatterGenConfig()
        self.device = resolve_device(device)
        if c.sample_dtype not in _DTYPES:
            raise ValueError(f"sample_dtype must be one of {list(_DTYPES)}")
        self.cell_sde = LatticeVPSDE(beta_min=c.beta_min, beta_max=c.beta_max)
        self.coord_ve = WrappedCoordVE(sigma_min=c.sigma_min, sigma_max=c.sigma_max)
        self.d3pm = TypeD3PM.create(
            num_classes=c.max_atomic_num, num_steps=c.timesteps, kind=c.d3pm_kind,
            device=self.device,
        )
        self.decoder = MatterGenScoreNet(
            hidden_dim=c.hidden_dim,
            time_dim=c.time_dim,
            num_layers=c.num_layers,
            type_vocab=self.d3pm.vocab,
            num_freqs=c.num_freqs,
            condition_fields=tuple(c.condition_fields),
            edge_style=c.edge_style,
        ).to(self.device)

    def apply_net(
        self, noised: MGNoised, num_atoms, mask, conditions=None, cond_mask=None,
        *, fused_edge: bool = False, dtype: torch.dtype = torch.float32,
    ) -> dict[str, torch.Tensor]:
        if conditions and self.config.condition_stats:
            stats = {f: (m, s) for f, m, s in self.config.condition_stats}
            conditions = {
                f: (v - stats[f][0]) / max(stats[f][1], 1e-8) if f in stats else v
                for f, v in conditions.items()
            }
        return self.decoder(
            noised.time_emb, noised.atom_types_t, noised.frac_coords_t,
            noised.lattice_t, num_atoms, mask, conditions=conditions,
            cond_mask=cond_mask, fused_edge=fused_edge, dtype=dtype,
        )

    def time_grid(self) -> torch.Tensor:
        """Descending grid ``linspace(1, 1/N, N)`` in f32, rounded as the
        JAX package's ``jnp.linspace`` comes out of XLA (see ``time_grid``)."""
        return time_grid(self.config.timesteps).to(self.device)

    # ------------------------------------------------------------- corruption
    def add_noise(
        self,
        batch: CrystalBatch,
        t_index: torch.Tensor | int,
        draws: NoiseDraws | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[MGNoised, MGTargets, torch.Tensor]:
        """Corrupt every field of ``batch`` at grid index ``t_index`` (an int
        or ``[B]``), with ``draws`` or, when none are given, draws from
        ``generator``."""
        c = self.config
        B, A = batch.batch_size, batch.max_atoms
        dev = batch.frac_coords.device
        if draws is None:
            draws = noise_draws((), B, A, self.d3pm.vocab, generator, dev)
        idx = torch.as_tensor(t_index, device=dev)
        t = self.time_grid().to(dev)[idx].expand(B)

        lattice_t, eps_cell, _ = self.cell_sde.sample_marginal(
            batch.lattice, t, batch.num_atoms, draws.cell
        )
        frac_t, eps_pos, sigma = self.coord_ve.sample_marginal(
            batch.frac_coords, t, draws.pos
        )
        # sigma-scaled score target: O(1) magnitudes
        score_pos = self.coord_ve.score_target(eps_pos, sigma) * sigma
        x0_types = torch.clamp(batch.atom_types.long() - 1, 0, self.d3pm.num_classes - 1)
        types_t = self.d3pm.sample_marginal(x0_types, t, draws.gumbel)
        time_emb = sinusoidal_time_embedding(t * c.timesteps, c.time_dim)
        noised = MGNoised(t, time_emb, types_t, frac_t, lattice_t)
        return noised, MGTargets(eps_cell, score_pos, x0_types), t

    # ----------------------------------------------------------------- losses
    def sample_losses(
        self, noised: MGNoised, targets: MGTargets, num_atoms, mask,
        conditions=None, cond_mask=None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(weighted per-crystal loss ``[B]``, predictions) of the f32 net on
        the plain edge path."""
        c = self.config
        preds = self.apply_net(noised, num_atoms, mask, conditions, cond_mask)
        loss_cell, loss_pos, loss_types = self._field_losses(preds, targets, noised, mask)
        loss = (
            c.weight_cell * loss_cell + c.weight_pos * loss_pos
            + c.weight_types * loss_types
        )
        return loss, preds

    def _field_losses(self, preds, targets: MGTargets, noised: MGNoised, mask):
        """Per-crystal (cell, pos, types) losses."""
        loss_cell = torch.mean((preds["cell"] - targets.eps_cell) ** 2, dim=(1, 2))
        loss_pos = graph_mean(torch.mean((preds["pos"] - targets.score_pos) ** 2, dim=-1), mask)
        loss_types = self.d3pm.hybrid_loss(
            targets.x0_types, noised.atom_types_t, preds["atomic_numbers"], noised.t,
            mask, hybrid_lambda=self.config.d3pm_hybrid_lambda,
        )
        return loss_cell, loss_pos, loss_types

    @staticmethod
    def kl_reg(agent_pred, prior_pred, mask) -> torch.Tensor:
        """``[B]`` squared distance of the agent's predictions from the
        prior's, per field; the prior's are constants."""
        prior_pred = {k: v.detach() for k, v in prior_pred.items()}
        kl0 = torch.mean((agent_pred["cell"] - prior_pred["cell"]) ** 2, dim=(1, 2))
        kl1 = graph_mean(torch.mean((agent_pred["pos"] - prior_pred["pos"]) ** 2, dim=-1), mask)
        kl2 = graph_mean(
            torch.mean((agent_pred["atomic_numbers"] - prior_pred["atomic_numbers"]) ** 2, dim=-1),
            mask,
        )
        return kl0 + kl1 + kl2

    def _rl_terms(
        self, prior: "MatterGenDiffusion", batch: CrystalBatch, rewards: torch.Tensor,
        t_indices: torch.Tensor, draws: NoiseDraws | None,
        generator: torch.Generator | None, conditions,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(reward-weighted loss, KL term) ``[C, B]`` for the C grid indices
        ``t_indices``, all through one batched forward of each net."""
        C, B, A = len(t_indices), batch.batch_size, batch.max_atoms
        dev = batch.frac_coords.device
        if draws is None:
            draws = noise_draws((C,), B, A, self.d3pm.vocab, generator, dev)
        big = CrystalBatch(
            atom_types=batch.atom_types.repeat(C, 1),
            frac_coords=batch.frac_coords.repeat(C, 1, 1),
            lattice=batch.lattice.repeat(C, 1, 1),
            num_atoms=batch.num_atoms.repeat(C),
        )
        flat = NoiseDraws(*(d.reshape(C * B, *d.shape[2:]) for d in draws))
        t_idx = torch.as_tensor(t_indices, device=dev).repeat_interleave(B)
        cond = None if conditions is None else {k: v.repeat(C) for k, v in conditions.items()}
        noised, targets, _ = self.add_noise(big, t_idx, flat)
        mask = big.mask
        loss, agent_pred = self.sample_losses(noised, targets, big.num_atoms, mask, cond)
        with torch.no_grad():
            prior_pred = prior.apply_net(noised, big.num_atoms, mask, cond)
        kl = self.kl_reg(agent_pred, prior_pred, mask)
        r = rewards.to(torch.float32).repeat(C)
        loss_diff = r * loss
        # (1.1 - reward) weights the KL, as the JAX package does
        loss_kl = kl * (1.1 - r)
        return loss_diff.reshape(C, B), loss_kl.reshape(C, B)

    def rl_timestep_loss(
        self, prior: "MatterGenDiffusion", batch: CrystalBatch, rewards: torch.Tensor,
        t_index: int, sigma_kl: float, draws: NoiseDraws | None = None,
        generator: torch.Generator | None = None, conditions=None,
    ):
        """Reward-weighted loss plus KL at one grid index: (mean over the
        batch, (sum of the loss terms, sum of the KL terms)). ``draws`` have
        no leading axis."""
        if draws is not None:
            draws = NoiseDraws(*(d[None] for d in draws))
        ld, lk = self._rl_terms(
            prior, batch, rewards, torch.tensor([int(t_index)]), draws, generator, conditions
        )
        return torch.mean(ld + lk * sigma_kl), (ld.sum(), lk.sum())

    def rl_chunk_loss(
        self, prior: "MatterGenDiffusion", batch: CrystalBatch, rewards: torch.Tensor,
        t_indices: torch.Tensor, sigma_kl: float, draws: NoiseDraws | None = None,
        generator: torch.Generator | None = None, conditions=None,
    ):
        """``rl_timestep_loss`` over the grid indices ``t_indices`` ``[C]``:
        (mean of the per-timestep losses, summed loss and KL terms).
        ``draws`` carry a leading ``C`` axis."""
        ld, lk = self._rl_terms(prior, batch, rewards, t_indices, draws, generator, conditions)
        per_t = torch.mean(ld + lk * sigma_kl, dim=1)
        return torch.mean(per_t), (ld.sum(), lk.sum())

    # --------------------------------------------------------------- sampling

    def _guided_preds(
        self, noised, num_atoms, mask, conditions, guidance, *, fused_edge, dtype
    ):
        """Classifier-free guidance: ``(1+g) cond - g uncond`` per field."""
        kw = dict(fused_edge=fused_edge, dtype=dtype)
        if not conditions or guidance == 0.0:
            return self.apply_net(noised, num_atoms, mask, conditions, **kw)
        cond_preds = self.apply_net(noised, num_atoms, mask, conditions, **kw)
        B = num_atoms.shape[0]
        null_mask = {
            f: torch.zeros((B,), dtype=torch.bool, device=num_atoms.device)
            for f in conditions
        }
        uncond_preds = self.apply_net(
            noised, num_atoms, mask, conditions, cond_mask=null_mask, **kw
        )
        return {
            k: (1.0 + guidance) * cond_preds[k] - guidance * uncond_preds[k]
            for k in cond_preds
        }

    def _sample_init(self, noise: NoiseSource, num_atoms: torch.Tensor, A: int):
        """Prior draw for one (sub-)batch: state, mask, sigma_lim."""
        B = num_atoms.shape[0]
        mask = torch.arange(A, device=num_atoms.device)[None, :] < num_atoms[:, None]
        z_cell, u_pos, type_draw = noise.prior(B, A, self.d3pm.vocab, num_atoms.device)
        sigma_lim = self.cell_sde.limit_std(num_atoms)[:, None, None]
        cell = self.cell_sde.prior_sample(z_cell, num_atoms)
        pos = self.coord_ve.prior_sample(u_pos)
        types = self.d3pm.prior_sample(type_draw)
        return (cell, pos, types), mask, sigma_lim

    def _step_tables(self) -> dict[str, torch.Tensor]:
        """Per-step scalar and embedding tables of the (static) time grid."""
        c = self.config
        N = c.timesteps
        grid = self.time_grid()  # [N] descending
        t_prev = torch.clamp(grid - 1.0 / N, min=0.0)
        last = torch.arange(N, device=grid.device) == (N - 1)
        zero = torch.zeros((), device=grid.device)
        nz = torch.where(last, zero, torch.ones((), device=grid.device))
        time_emb = sinusoidal_time_embedding(grid * N, c.time_dim)  # [N, D]
        sigma_now = self.coord_ve.sigma(grid)
        sigma_prev = torch.where(last, zero, self.coord_ve.sigma(t_prev))
        abar_now = torch.exp(-self.cell_sde._B(grid))
        abar_prev = torch.exp(-self.cell_sde._B(t_prev))
        alpha_i = abar_now / abar_prev
        beta_i = 1.0 - alpha_i
        post_std = torch.sqrt(
            torch.clamp(
                beta_i * (1.0 - abar_prev) / torch.clamp(1.0 - abar_now, min=1e-12),
                min=0.0,
            )
        )
        p_step = sigma_now**2 - sigma_prev**2
        p_std = torch.sqrt(
            torch.clamp(sigma_prev**2 * p_step, min=0.0)
            / torch.clamp(sigma_now**2, min=1e-12)
        )
        corr_step = (c.corrector_snr * sigma_now) ** 2 * 2.0
        return dict(
            t=grid, nz=nz, time_emb=time_emb,
            inv_sigma=1.0 / torch.clamp(sigma_now, min=1e-8),
            eps_coef=beta_i / torch.sqrt(1.0 - abar_now),
            inv_sqrt_alpha=1.0 / torch.sqrt(alpha_i),
            post_std=post_std, p_step=p_step, p_std=p_std,
            corr_step=corr_step, corr_noise=torch.sqrt(2.0 * corr_step),
        )

    def _sample_step(
        self, carry, i: int, *, num_atoms, mask, sigma_lim, noise: NoiseSource,
        conditions, guidance, tables, fused_edge: bool, record_traj: bool = False,
        fixed_types: bool = False,
    ):
        """One predictor-corrector update of one (sub-)batch at grid step i:
        the next state and, with ``record_traj``, the transition's record
        (else None). ``fixed_types`` holds the types (CSP mode)."""
        c = self.config
        N = c.timesteps
        B, A = mask.shape
        dtype = _DTYPES[c.sample_dtype]
        tb = {k: v[i] for k, v in tables.items()}
        t_vec = tb["t"].expand(B)
        time_emb = tb["time_emb"][None, :].expand(B, c.time_dim)

        def net_preds(cell_t, pos_t, types_t):
            noised = MGNoised(t_vec, time_emb, types_t, pos_t, cell_t)
            return self._guided_preds(
                noised, num_atoms, mask, conditions, guidance,
                fused_edge=fused_edge, dtype=dtype,
            )

        cell_t, pos_t, types_t = carry
        cell_in, pos_in = cell_t, pos_t
        draws = noise.step(i, B, A, self.d3pm.vocab, c.n_corrector, mask.device)
        nz = tb["nz"]

        # corrector: Langevin on coords (snr-scaled)
        corr_mu = pos_t  # the first kick's mean (the recorder's)
        for ci in range(c.n_corrector):
            preds = net_preds(cell_t, pos_t, types_t)
            score = preds["pos"] * tb["inv_sigma"]
            mu = pos_t - tb["corr_step"] * score
            pos_t = mu + tb["corr_noise"] * (nz * draws.corr[ci])
            if ci == 0:
                corr_mu = mu
        if record_traj:
            # the replay sees the wrapped coords: let the predictor too
            pos_t = pos_t % 1.0

        # predictor
        preds = net_preds(cell_t, pos_t, types_t)

        # cell: VP ancestral step in sigma_lim-normalized space
        cell_n = cell_t / sigma_lim
        mean_n = (cell_n - tb["eps_coef"] * preds["cell"]) * tb["inv_sqrt_alpha"]
        cell_next = sigma_lim * (mean_n + nz * tb["post_std"] * draws.cell)
        if c.sample_clip is not None:
            cell_next = torch.clamp(cell_next, -c.sample_clip, c.sample_clip)

        # coords: VE ancestral (sigma^2 difference) with sigma-scaled score
        score = preds["pos"] * tb["inv_sigma"]
        pos_next = (pos_t - tb["p_step"] * score + nz * tb["p_std"] * draws.pos) % 1.0

        # types: D3PM ancestral draw from the tempered posterior; the last
        # grid step takes its mode (held in CSP mode)
        if fixed_types:
            types_next = types_t
        else:
            post_logits = self.d3pm.posterior_logits(
                types_t, preds["atomic_numbers"], t_vec
            ) / c.type_temperature
            if i == N - 1:
                types_next = torch.argmax(post_logits, dim=-1)
            else:
                types_next = torch.argmax(post_logits + draws.gumbel, dim=-1)
        if not record_traj:
            return (cell_next, pos_next, types_next), None
        # the transition's log-probs, each gated by nz: the last grid step is
        # deterministic (noise off, argmax types) and records 0
        lp_cell, lp_pos, lp_types = self._transition_logprobs(
            tb, mask, sigma_lim, mean_n, cell_next, pos_t, corr_mu, score, pos_next,
            None if fixed_types else post_logits, types_next,
        )
        rec = dict(
            cell_in=cell_in, pos_in=pos_in, types_in=types_t, pos_mid=pos_t,
            cell=cell_next, pos=pos_next, types=types_next,
            log_prob_cell=lp_cell, log_prob_pos=lp_pos, log_prob_types=lp_types,
        )
        return (cell_next, pos_next, types_next), rec

    @staticmethod
    def _transition_logprobs(tb, mask, sigma_lim, mean_n, cell_next, pos_mid, corr_mu,
                             score, pos_next, post_logits, types_next):
        """(log_prob_cell, log_prob_pos, log_prob_types) ``[B]`` of one
        transition; the recorder and ``forward_logprob`` share them."""
        nz, tiny = tb["nz"], 1e-12
        lp_cell = nz * norm_logpdf(
            cell_next, sigma_lim * mean_n, torch.clamp(sigma_lim * tb["post_std"], min=tiny)
        ).mean(dim=(1, 2))
        lp_pos_corr = nz * graph_mean(
            log_prob_wrapped_normal(
                pos_mid % 1.0, corr_mu % 1.0, torch.clamp(tb["corr_noise"], min=tiny)
            ).mean(dim=-1),
            mask,
        )
        mu_pred = (pos_mid - tb["p_step"] * score) % 1.0
        lp_pos_pred = nz * graph_mean(
            log_prob_wrapped_normal(pos_next, mu_pred, torch.clamp(tb["p_std"], min=tiny)).mean(dim=-1),
            mask,
        )
        if post_logits is None:
            lp_types = torch.zeros_like(lp_cell)
        else:
            lp = torch.log_softmax(post_logits, dim=-1)
            lp_types = nz * graph_mean(torch.gather(lp, -1, types_next[..., None])[..., 0], mask)
        return lp_cell, lp_pos_corr + lp_pos_pred, lp_types

    # -------------------------------------------------- DDPO policy gradients
    def forward_logprob(
        self, state: Mapping[str, Any], num_atoms, mask, tables=None, conditions=None,
        guidance: float = 0.0, fixed_types=None,
    ):
        """Differentiable log-probs of stored transitions: ``state`` holds
        ``step`` (the grid index: an int, or ``[B]`` for one per row),
        ``cell_in``, ``pos_in``, ``types_in``, ``pos_mid`` and the realized
        ``cell``, ``pos``, ``types``.
        ``conditions``, ``guidance`` and ``fixed_types`` must be those the
        trajectory was sampled with. Runs the plain net in the sampling
        dtype, as the recorder did. Returns (lp_cell, lp_types, lp_pos,
        predictions)."""
        c = self.config
        if c.n_corrector != 1:
            raise NotImplementedError(
                "MatterGen DDPO replay supports n_corrector=1 (the default); "
                "intermediate corrector states are not recorded"
            )
        tables = tables if tables is not None else self._step_tables()
        B = num_atoms.shape[0]
        step = torch.as_tensor(state["step"])
        if step.dim() == 0:
            tb = {k: v[int(step)] for k, v in tables.items()}
            t_vec = tb["t"].expand(B)
            time_emb = tb["time_emb"][None, :].expand(B, c.time_dim)
        else:
            # one step per row: per-row coefficients broadcast over the
            # atoms, the gate nz over the per-crystal log-probs
            idx = step.to(tables["t"].device).long()
            tb = {k: v[idx][:, None, None] for k, v in tables.items() if k not in ("t", "time_emb", "nz")}
            tb["nz"] = tables["nz"][idx]
            t_vec, time_emb = tables["t"][idx], tables["time_emb"][idx]
        sigma_lim = self.cell_sde.limit_std(num_atoms)[:, None, None]
        dtype = _DTYPES[c.sample_dtype]

        def net_eval(cell_t, pos_t, types_t):
            noised = MGNoised(t_vec, time_emb, types_t, pos_t, cell_t)
            preds = self._guided_preds(
                noised, num_atoms, mask, conditions, guidance, fused_edge=False, dtype=dtype,
            )
            return {k: v.to(torch.float32) for k, v in preds.items()}

        cell_in, pos_in, types_in, pos_mid = (
            state["cell_in"], state["pos_in"], state["types_in"], state["pos_mid"]
        )
        preds_c = net_eval(cell_in, pos_in, types_in)
        corr_mu = pos_in - tb["corr_step"] * (preds_c["pos"] * tb["inv_sigma"])
        preds = net_eval(cell_in, pos_mid, types_in)
        mean_n = (cell_in / sigma_lim - tb["eps_coef"] * preds["cell"]) * tb["inv_sqrt_alpha"]
        score = preds["pos"] * tb["inv_sigma"]
        post_logits = None
        if fixed_types is None:
            post_logits = self.d3pm.posterior_logits(
                types_in, preds["atomic_numbers"], t_vec
            ) / c.type_temperature
        lp_cell, lp_pos, lp_types = self._transition_logprobs(
            tb, mask, sigma_lim, mean_n, state["cell"], pos_mid, corr_mu, score,
            state["pos"], post_logits, state["types"],
        )
        return lp_cell, lp_types, lp_pos, preds

    def _finalize(self, state, mask, num_atoms) -> CrystalBatch:
        cell, pos, types = state
        # D3PM classes are 0-based; MASK (absorbing) maps to 0 = invalid
        atom_types = torch.where(types < self.d3pm.num_classes, types + 1, 0)
        atom_types = torch.where(mask, atom_types, 0).to(torch.int32)
        return CrystalBatch(
            atom_types=atom_types, frac_coords=pos % 1.0, lattice=cell,
            num_atoms=num_atoms,
        )

    @torch.no_grad()
    def sample(
        self,
        noise: NoiseSource | torch.Generator,
        num_atoms: torch.Tensor,
        max_atoms: int | None = None,
        conditions: Mapping[str, torch.Tensor] | None = None,
        guidance: float = 0.0,
        *,
        fused_edge: bool = True,
        record_traj: bool = False,
        fixed_types: torch.Tensor | None = None,
    ):
        """Predictor-corrector ancestral sampling of one padded batch.

        ``fixed_types`` ``[B, A]`` (1-based) holds the types through the
        chain (CSP mode). With ``record_traj`` returns ``(batch,
        trajectory)``: the transitions' states and log-probs stacked
        ``[N, B, ...]`` and ``step [N]``, recorded on the plain net (the
        kernel's rounding would move the replay's importance ratios off 1);
        else the batch alone."""
        if record_traj and self.config.n_corrector != 1:
            # one (corr_mu, pos_mid) pair is recorded per grid step
            raise NotImplementedError(
                "record_traj=True supports n_corrector=1 (the default); "
                "intermediate corrector states are not recorded"
            )
        noise = _as_noise(noise)
        A = int(max_atoms) if max_atoms is not None else 20
        num_atoms = torch.clamp(num_atoms.to(self.device), max=A)
        state, mask, sigma_lim = self._sample_init(noise, num_atoms, A)
        if fixed_types is not None:
            types = torch.clamp(fixed_types.to(self.device).long() - 1, 0, self.d3pm.num_classes - 1)
            state = (state[0], state[1], types)
        tables = self._step_tables()
        rec: dict[str, list] = {}
        for i in range(self.config.timesteps):
            state, ys = self._sample_step(
                state, i, num_atoms=num_atoms, mask=mask, sigma_lim=sigma_lim,
                noise=noise, conditions=conditions, guidance=guidance,
                tables=tables, fused_edge=fused_edge and not record_traj,
                record_traj=record_traj, fixed_types=fixed_types is not None,
            )
            for k, v in (ys or {}).items():
                rec.setdefault(k, []).append(v)
        final = self._finalize(state, mask, num_atoms)
        if not record_traj:
            return final
        traj = {k: torch.stack(v) for k, v in rec.items()}
        traj["step"] = torch.arange(self.config.timesteps, device=self.device)
        return final, traj

    @torch.no_grad()
    def sample_bucketed(
        self,
        noise: NoiseSource | torch.Generator | Sequence[NoiseSource],
        num_atoms_buckets: Sequence[torch.Tensor],
        bucket_max_atoms: Sequence[int],
        conditions_buckets: Sequence | None = None,
        guidance: float = 0.0,
        *,
        fused_edge: bool = True,
    ) -> list[CrystalBatch]:
        """Size-bucketed sampling: every bucket, padded to its own atom cap,
        advances one grid step per loop iteration. Returns one
        ``CrystalBatch`` per bucket. ``noise`` is one source shared by the
        buckets or a sequence with one per bucket."""
        n_b = len(num_atoms_buckets)
        if isinstance(noise, (list, tuple)):
            noises = [_as_noise(n) for n in noise]
        else:
            noises = [_as_noise(noise)] * n_b
        num_atoms_buckets = [
            torch.clamp(na.to(self.device), max=int(cap))
            for na, cap in zip(num_atoms_buckets, bucket_max_atoms)
        ]
        conds = conditions_buckets or (None,) * n_b
        inits = [
            self._sample_init(noises[bi], num_atoms_buckets[bi], int(bucket_max_atoms[bi]))
            for bi in range(n_b)
        ]
        states = [it[0] for it in inits]
        tables = self._step_tables()
        for i in range(self.config.timesteps):
            states = [
                self._sample_step(
                    states[bi], i, num_atoms=num_atoms_buckets[bi],
                    mask=inits[bi][1], sigma_lim=inits[bi][2], noise=noises[bi],
                    conditions=conds[bi], guidance=guidance, tables=tables,
                    fused_edge=fused_edge,
                )[0]
                for bi in range(n_b)
            ]
        return [
            self._finalize(states[bi], inits[bi][1], num_atoms_buckets[bi])
            for bi in range(n_b)
        ]


def time_grid(N: int) -> torch.Tensor:
    """``linspace(1, 1/N, N)`` in f32 on the CPU, rounded as XLA computes
    the JAX package's ``jnp.linspace(1.0, 1.0 / N, N)``.

    XLA folds ``start (1 - i / d) + stop (i / d)`` (``d = N - 1``) into
    ``(1 - i r) + i c`` with the f32 constants ``r = 1 / d`` and
    ``c = stop r``, and its CPU loop contracts both products into fused
    multiply-adds: ``fma(i, c, fma(-i, r, 1))``. Each fma is formed exactly
    in f64 and rounded once to f32 (exact for ``N < 2^14``). XLA's scalar
    remainder loop rounds ``1 - i r`` before it adds ``i c``, so the last
    few points of JAX's grid differ from these by up to 2^-24 (7 of 1000
    at T = 1000, 1 of 8 at T = 8); ``tests/test_torch_port_faults.py`` pins
    that and what it moves.
    """
    if N == 1:
        return torch.ones(1, dtype=torch.float32)
    f32, f64 = torch.float32, torch.float64
    stop = torch.tensor(1.0 / N, dtype=f32)
    r = torch.tensor(1.0, dtype=f32) / (N - 1)
    c = stop * r
    i = torch.arange(N - 1, dtype=f64)
    inner = (1.0 - i * r.to(f64)).to(f32)
    body = (i * c.to(f64) + inner.to(f64)).to(f32)
    return torch.cat([body, stop[None]])


def _as_noise(noise: NoiseSource | torch.Generator) -> NoiseSource:
    return GeneratorNoise(noise) if isinstance(noise, torch.Generator) else noise
