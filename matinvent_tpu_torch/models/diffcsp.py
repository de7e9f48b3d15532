"""DiffCSP-class joint diffusion (``matinvent_tpu/models/diffcsp.py``).

Three fields diffuse together: a DDPM/VP chain on the lattice, a
score-matching wrapped normal on the fractional coords and a Gaussian-relaxed
one-hot of the atom types. The score net is the port's ``CSPNet`` with the
relaxed one-hot input and the type head (``self.decoder``, parameter names as
the checkpoints' flax tree carried over by ``models/suite/diffcsp.py``). It
never runs the fused edge kernel: the JAX package builds DiffCSP's
``CSPNet`` without ``fused_edge``.

``sample`` is the predictor-corrector sampler over t = T..1 (a Langevin
corrector on the coords, then the ancestral step of all three fields) as a
Python loop; its draws come from a ``CSPNoiseSource``: ``CSPGeneratorNoise``
over an explicit ``torch.Generator``, or ``CSPArrayNoise`` holding another
implementation's exact draws. With ``record_traj`` it returns the
trajectory and the log-probs of its transitions, which ``forward_logprob``
recomputes for DDPO (``parallel/train.py``); the recorder wraps the
post-corrector coords into [0, 1) before the predictor, so the replay of the
recorded state repeats the recorder's arithmetic exactly (the JAX recorder
keeps them unwrapped, which moves the replayed log-probs by rounding).

The training half (``add_noise``, ``sample_losses``, ``kl_reg``,
``rl_timestep_loss``, ``rl_chunk_loss``, ``training_loss``) runs the f32
net. ``add_noise`` takes its draws as ``NoiseDraws`` (JAX's draws in the
tests) or makes them from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple

import torch
from torch import nn

from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.models.batch import MAX_ATOMIC_NUM, CrystalBatch
from matinvent_tpu_torch.models.cspnet import CSPNet
from matinvent_tpu_torch.ops.schedules import BetaSchedule, SigmaSchedule
from matinvent_tpu_torch.ops.segment import graph_mean
from matinvent_tpu_torch.ops.wrapped_normal import (
    d_log_p_wrapped_normal,
    log_prob_wrapped_normal,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sinusoidal_time_embedding(times: torch.Tensor, dim: int) -> torch.Tensor:
    """Transformer-style time embedding ``[N] -> [N, dim]``, in float32."""
    half_dim = dim // 2
    factor = math.log(10000.0) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=times.device) * -factor
    )
    emb = times.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def norm_logpdf(x: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Gaussian log-density, as ``jax.scipy.stats.norm.logpdf`` computes it:
    ``(log(2 pi scale^2) + (x - loc)^2 / scale^2) / -2``."""
    s2 = scale * scale
    return (torch.log(2 * math.pi * s2) + (x - loc) ** 2 / s2) / -2.0


class NoisedInput(NamedTuple):
    """Inputs of the score net after corruption."""

    time_emb: torch.Tensor  # [B, time_dim]
    atom_probs: torch.Tensor  # [B, A, K]
    frac_coords: torch.Tensor  # [B, A, 3]
    lattice: torch.Tensor  # [B, 3, 3]


class NoiseTargets(NamedTuple):
    rand_l: torch.Tensor  # [B, 3, 3]
    tar_x: torch.Tensor  # [B, A, 3] normalized wrapped-normal score target
    rand_t: torch.Tensor  # [B, A, K]


class NoiseDraws(NamedTuple):
    """The standard-normal draws of ``add_noise``, with any leading axes
    before ``B``."""

    lattice: torch.Tensor  # [..., B, 3, 3]
    coords: torch.Tensor  # [..., B, A, 3]
    types: torch.Tensor  # [..., B, A, K]


def noise_draws(lead: tuple[int, ...], B: int, A: int, K: int,
                generator: torch.Generator, device) -> NoiseDraws:
    return NoiseDraws(
        torch.randn((*lead, B, 3, 3), generator=generator, device=device),
        torch.randn((*lead, B, A, 3), generator=generator, device=device),
        torch.randn((*lead, B, A, K), generator=generator, device=device),
    )


@dataclass(frozen=True)
class DiffCSPConfig:
    """The JAX package's ``DiffCSPConfig`` fields and defaults."""

    hidden_dim: int = 128
    num_layers: int = 4
    time_dim: int = 256
    num_freqs: int = 10
    ln: bool = False
    ip: bool = True
    edge_style: str = "fc"
    cutoff: float = 6.0
    max_neighbors: int = 20
    timesteps: int = 1000
    scheduler_mode: str = "cosine"
    sigma_begin: float = 0.01
    sigma_end: float = 1.0
    # weights of the per-element-mean field losses; cost < 1e-5 freezes a
    # field (keep_lattice / keep_coords)
    cost_lattice: float = 1.0
    cost_coord: float = 1.0
    cost_type: float = 1.0
    max_atomic_num: int = MAX_ATOMIC_NUM
    # compute dtype of the score-net evals inside the sampling loop
    sample_dtype: str = "float32"
    # clip of the lattice entries and type logits inside the sampling loop
    sample_clip: float | None = None

    @classmethod
    def from_dict(cls, values: Mapping[str, Any]) -> "DiffCSPConfig":
        """Config from a flat mapping; unknown keys (a checkpoint's stale
        ones included) are dropped."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in values.items() if k in names})


class CSPStepDraws(NamedTuple):
    corr: torch.Tensor  # [B, A, 3] corrector kick
    lattice: torch.Tensor  # [B, 3, 3]
    types: torch.Tensor  # [B, A, K]
    coords: torch.Tensor  # [B, A, 3] predictor kick


class CSPNoiseSource:
    """Where ``DiffCSPDiffusion.sample`` takes its draws from."""

    def prior(self, B: int, A: int, K: int, device):
        """(uniform coords ``[B,A,3]``, normal lattice ``[B,3,3]``, normal
        type logits ``[B,A,K]``)."""
        raise NotImplementedError

    def step(self, i: int, B: int, A: int, K: int, device) -> CSPStepDraws:
        """The standard-normal draws of loop step ``i`` (t = T - i)."""
        raise NotImplementedError


class CSPGeneratorNoise(CSPNoiseSource):
    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def prior(self, B, A, K, device):
        g = self.generator
        return (
            torch.rand((B, A, 3), generator=g, device=device),
            torch.randn((B, 3, 3), generator=g, device=device),
            torch.randn((B, A, K), generator=g, device=device),
        )

    def step(self, i, B, A, K, device):
        g = self.generator
        return CSPStepDraws(
            torch.randn((B, A, 3), generator=g, device=device),
            torch.randn((B, 3, 3), generator=g, device=device),
            torch.randn((B, A, K), generator=g, device=device),
            torch.randn((B, A, 3), generator=g, device=device),
        )


class CSPArrayNoise(CSPNoiseSource):
    """Fixed draws: ``prior = (x, l, tt)`` and per-step arrays ``corr
    [T,B,A,3]``, ``lattice [T,B,3,3]``, ``types [T,B,A,K]``, ``coords
    [T,B,A,3]`` (numpy or torch)."""

    def __init__(self, prior, corr, lattice, types, coords):
        self._prior = prior
        self._steps = (corr, lattice, types, coords)

    def prior(self, B, A, K, device):
        return tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in self._prior)

    def step(self, i, B, A, K, device):
        return CSPStepDraws(
            *(torch.as_tensor(a[i], dtype=torch.float32, device=device) for a in self._steps)
        )


class CSPRowNoise(CSPNoiseSource):
    """Rows ``rows`` of the draws ``inner`` makes for a batch of ``total``
    rows: a data-parallel rank samples its block of the global batch on the
    draws the single process would make (``parallel/mesh.py``)."""

    def __init__(self, inner: CSPNoiseSource | torch.Generator, rows: slice, total: int):
        self.inner = CSPGeneratorNoise(inner) if isinstance(inner, torch.Generator) else inner
        self.rows = rows
        self.total = total

    def prior(self, B, A, K, device):
        return tuple(x[self.rows] for x in self.inner.prior(self.total, A, K, device))

    def step(self, i, B, A, K, device):
        return CSPStepDraws(*(x[self.rows] for x in self.inner.step(i, self.total, A, K, device)))


# the keys of one recorded transition, as the JAX recorder names them
TRAJ_STATE_KEYS = (
    "frac_coords", "lattices", "atom_types", "frac_coords_mid",
    "next_frac_coords", "next_lattices", "next_atom_types",
)


class DiffCSPDiffusion(nn.Module):
    """The score net (``self.decoder``), the schedules and the sampler."""

    def __init__(self, config: DiffCSPConfig | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.config = c = config or DiffCSPConfig()
        self.device = resolve_device(device)
        if c.sample_dtype not in _DTYPES:
            raise ValueError(f"sample_dtype must be one of {list(_DTYPES)}")
        self.decoder = CSPNet(
            hidden_dim=c.hidden_dim, latent_dim=c.time_dim, num_layers=c.num_layers,
            max_atoms=c.max_atomic_num, num_freqs=c.num_freqs, ln=c.ln,
            smooth=True, pred_type=True, edge_style=c.edge_style, cutoff=c.cutoff,
            max_neighbors=c.max_neighbors, ip=c.ip,
        ).to(self.device)
        self.beta = BetaSchedule.create(c.timesteps, c.scheduler_mode)
        self.sigma = SigmaSchedule.create(c.timesteps, c.sigma_begin, c.sigma_end)
        self._tables = {
            name: t.to(self.device)
            for name, t in dict(
                alphas=self.beta.alphas, alphas_cumprod=self.beta.alphas_cumprod,
                beta_sigmas=self.beta.sigmas, sigmas=self.sigma.sigmas,
                sigmas_norm=self.sigma.sigmas_norm,
            ).items()
        }
        self.keep_lattice = c.cost_lattice < 1e-5
        self.keep_coords = c.cost_coord < 1e-5
        # the suite attaches the checkpoint's scalers (carried, not applied)
        self.lattice_scaler = None
        self.prop_scaler = None

    def tables(self, device) -> dict[str, torch.Tensor]:
        if self._tables["alphas"].device != torch.device(device):
            return {k: v.to(device) for k, v in self._tables.items()}
        return self._tables

    def apply_net(self, noised: NoisedInput, num_atoms, mask,
                  dtype: torch.dtype = torch.float32):
        """(lattice ``[B,3,3]``, coords ``[B,A,3]``, type logits ``[B,A,K]``),
        in float32, from the net computed in ``dtype``."""
        return self.decoder(
            noised.time_emb, noised.atom_probs, noised.frac_coords, noised.lattice,
            num_atoms, mask, dtype=dtype,
        )

    # ------------------------------------------------------------- corruption
    def add_noise(
        self,
        batch: CrystalBatch,
        t_index: torch.Tensor | int | None = None,
        draws: NoiseDraws | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[NoisedInput, NoiseTargets, torch.Tensor]:
        """Corrupt ``batch`` at ``t_index`` (an int or ``[B]``: an index into
        the descending times ``T..1``, 0 being t = T; ``None`` draws t
        uniformly from 1..T with ``generator``), with ``draws`` or, when none
        are given, draws from ``generator``."""
        c = self.config
        B, A = batch.batch_size, batch.max_atoms
        dev = batch.frac_coords.device
        tb = self.tables(dev)
        if t_index is None:
            times = self.beta.uniform_sample_t(generator, B, dev)
        else:
            times = (c.timesteps - torch.as_tensor(t_index, device=dev)).to(torch.long).expand(B)
        if draws is None:
            draws = noise_draws((), B, A, c.max_atomic_num, generator, dev)
        time_emb = sinusoidal_time_embedding(times, c.time_dim)
        abar = tb["alphas_cumprod"][times]
        c0 = torch.sqrt(abar)[:, None, None]
        c1 = torch.sqrt(1.0 - abar)[:, None, None]
        sigmas = tb["sigmas"][times][:, None, None]
        sigmas_norm = tb["sigmas_norm"][times]

        input_lattice = c0 * batch.lattice + c1 * draws.lattice
        input_frac = (batch.frac_coords + sigmas * draws.coords) % 1.0
        if self.keep_lattice:
            input_lattice = batch.lattice
        if self.keep_coords:
            input_frac = batch.frac_coords
        gt_onehot = batch.atom_onehot(c.max_atomic_num)
        atom_type_probs = c0 * gt_onehot + c1 * draws.types
        tar_x = d_log_p_wrapped_normal(sigmas * draws.coords, sigmas) / torch.sqrt(
            sigmas_norm
        )[:, None, None]
        noised = NoisedInput(time_emb, atom_type_probs, input_frac, input_lattice)
        return noised, NoiseTargets(draws.lattice, tar_x, draws.types), times

    # ----------------------------------------------------------------- losses
    def sample_losses(self, noised: NoisedInput, targets: NoiseTargets, num_atoms, mask):
        """(weighted per-crystal loss ``[B]``, predictions) of the f32 net."""
        c = self.config
        pred_l, pred_x, pred_t = self.apply_net(noised, num_atoms, mask)
        loss_lattice = torch.mean((pred_l - targets.rand_l) ** 2, dim=(1, 2))
        loss_coord = graph_mean(torch.mean((pred_x - targets.tar_x) ** 2, dim=-1), mask)
        loss_type = graph_mean(torch.mean((pred_t - targets.rand_t) ** 2, dim=-1), mask)
        loss = c.cost_lattice * loss_lattice + c.cost_coord * loss_coord + c.cost_type * loss_type
        return loss, (pred_l, pred_x, pred_t)

    @staticmethod
    def kl_reg(agent_pred, prior_pred, mask) -> torch.Tensor:
        """``[B]`` squared distance of the agent's predictions from the
        prior's (constants), per field."""
        pred_l, pred_x, pred_t = agent_pred
        pl, px, pt = (p.detach() for p in prior_pred)
        kl0 = torch.mean((pred_l - pl) ** 2, dim=(1, 2))
        kl1 = graph_mean(torch.mean((pred_x - px) ** 2, dim=-1), mask)
        kl2 = graph_mean(torch.mean((pred_t - pt) ** 2, dim=-1), mask)
        return kl0 + kl1 + kl2

    def _rl_terms(self, prior: "DiffCSPDiffusion", batch: CrystalBatch, rewards,
                  t_indices: torch.Tensor, draws: NoiseDraws | None,
                  generator: torch.Generator | None):
        """(reward-weighted loss, KL term) ``[C, B]`` for the C time indices
        ``t_indices``, through one batched forward of each net."""
        C, B, A = len(t_indices), batch.batch_size, batch.max_atoms
        dev = batch.frac_coords.device
        if draws is None:
            draws = self.rl_draws(C, B, A, generator, dev)
        big = CrystalBatch(
            atom_types=batch.atom_types.repeat(C, 1),
            frac_coords=batch.frac_coords.repeat(C, 1, 1),
            lattice=batch.lattice.repeat(C, 1, 1),
            num_atoms=batch.num_atoms.repeat(C),
        )
        flat = NoiseDraws(*(d.reshape(C * B, *d.shape[2:]) for d in draws))
        t_idx = torch.as_tensor(t_indices, device=dev).repeat_interleave(B)
        noised, targets, _ = self.add_noise(big, t_idx, flat)
        mask = big.mask
        loss, agent_pred = self.sample_losses(noised, targets, big.num_atoms, mask)
        with torch.no_grad():
            prior_pred = prior.apply_net(noised, big.num_atoms, mask)
        kl = self.kl_reg(agent_pred, prior_pred, mask)
        r = rewards.to(torch.float32).repeat(C)
        loss_diff = r * loss
        # (1.1 - reward) weights the KL, as the JAX package does
        loss_kl = kl * (1.1 - r)
        return loss_diff.reshape(C, B), loss_kl.reshape(C, B)

    def rl_draws(self, C: int, B: int, A: int, generator: torch.Generator | None,
                 device) -> NoiseDraws:
        """The fine-tune's draws for ``C`` time indices of ``B`` crystals."""
        return noise_draws((C,), B, A, self.config.max_atomic_num, generator, device)

    def rl_timestep_loss(self, prior, batch, rewards, t_index: int, sigma_kl: float,
                         draws: NoiseDraws | None = None, generator=None, conditions=None):
        """Reward-weighted loss plus KL at one time index: (mean over the
        batch, (sum of the loss terms, sum of the KL terms)). DiffCSP is
        unconditional: ``conditions`` must be None."""
        if conditions is not None:
            raise ValueError("DiffCSP is unconditional; got conditions != None")
        if draws is not None:
            draws = NoiseDraws(*(d[None] for d in draws))
        ld, lk = self._rl_terms(prior, batch, rewards, torch.tensor([int(t_index)]), draws, generator)
        return torch.mean(ld + lk * sigma_kl), (ld.sum(), lk.sum())

    def rl_chunk_loss(self, prior, batch, rewards, t_indices, sigma_kl: float,
                      draws: NoiseDraws | None = None, generator=None, conditions=None):
        """``rl_timestep_loss`` over the time indices ``t_indices`` ``[C]``:
        (mean of the per-timestep losses, summed loss and KL terms).
        ``draws`` carry a leading ``C`` axis."""
        if conditions is not None:
            raise ValueError("DiffCSP is unconditional; got conditions != None")
        ld, lk = self._rl_terms(prior, batch, rewards, t_indices, draws, generator)
        return torch.mean(torch.mean(ld + lk * sigma_kl, dim=1)), (ld.sum(), lk.sum())

    def training_loss(self, batch: CrystalBatch, draws: NoiseDraws | None = None,
                      generator: torch.Generator | None = None, times_index=None):
        """The pretraining loss at uniform random timesteps (or
        ``times_index``): the fields normalized per atom (sum over
        components / valid atoms), as the JAX package weighs them."""
        c = self.config
        noised, targets, _ = self.add_noise(batch, times_index, draws, generator)
        mask = batch.mask
        pred_l, pred_x, pred_t = self.apply_net(noised, batch.num_atoms, mask)
        loss_lattice = torch.mean((pred_l - targets.rand_l) ** 2)
        m3 = mask[..., None].to(torch.float32)
        n_valid = torch.clamp(torch.sum(m3), min=1.0)
        loss_coord = torch.sum(((pred_x - targets.tar_x) ** 2) * m3) / n_valid
        loss_type = torch.sum(((pred_t - targets.rand_t) ** 2) * m3) / n_valid
        loss = c.cost_lattice * loss_lattice + c.cost_coord * loss_coord + c.cost_type * loss_type
        return loss, dict(loss=loss, loss_lattice=loss_lattice, loss_coord=loss_coord,
                          loss_type=loss_type)

    # ------------------------------------------------------ step coefficients
    def _coefs(self, t: torch.Tensor, step_lr: float) -> dict[str, torch.Tensor]:
        """The step's coefficients at times ``t`` ``[B]``, each ``[B, 1, 1]``:
        the sampler and ``forward_logprob`` share them."""
        c = self.config
        tb = self.tables(t.device)

        def g(name, idx):
            return tb[name][idx][:, None, None]

        alphas, abar = g("alphas", t), g("alphas_cumprod", t)
        sigma_x = g("sigmas", t)
        adj = g("sigmas", t - 1)
        step_size = step_lr * (sigma_x / c.sigma_begin) ** 2
        return dict(
            c0=1.0 / torch.sqrt(alphas),
            c1=(1 - alphas) / torch.sqrt(1 - abar),
            sigmas=g("beta_sigmas", t),
            sqrt_norm=torch.sqrt(g("sigmas_norm", t)),
            step_size=step_size,
            std_x=torch.sqrt(2 * step_size),
            p_step=sigma_x**2 - adj**2,
            p_std=torch.sqrt((adj**2 * (sigma_x**2 - adj**2)) / (sigma_x**2)),
        )

    def _eval_net(self, time_emb, t_t, x_t, l_t, num_atoms, mask):
        """Score-net eval in the sampling dtype; float32 outputs."""
        dtype = _DTYPES[self.config.sample_dtype]
        return self.apply_net(NoisedInput(time_emb, t_t, x_t, l_t), num_atoms, mask, dtype=dtype)

    @staticmethod
    def _transition_logprobs(k, mask, x_mid, x_mu_corr, x_next, x_mu_pred,
                             l_next, mu_l, t_next, mu_t):
        """(log_prob_l, log_prob_t, log_prob_x) ``[B]`` of one transition."""
        tiny = 1e-12
        lp_l = norm_logpdf(l_next, mu_l, torch.clamp(k["sigmas"], min=tiny)).mean(dim=(1, 2))
        lp_t = graph_mean(
            norm_logpdf(t_next, mu_t, torch.clamp(k["sigmas"], min=tiny)).mean(dim=-1), mask
        )
        lp_x_corr = graph_mean(
            log_prob_wrapped_normal(x_mid, x_mu_corr, torch.clamp(k["std_x"], min=tiny)).mean(dim=-1),
            mask,
        )
        lp_x_pred = graph_mean(
            log_prob_wrapped_normal(x_next, x_mu_pred, torch.clamp(k["p_std"], min=tiny)).mean(dim=-1),
            mask,
        )
        return lp_l, lp_t, lp_x_corr + lp_x_pred

    # -------------------------------------------------- DDPO policy gradients
    def forward_logprob(self, state: Mapping[str, torch.Tensor], mask: torch.Tensor,
                        step_lr: float = 5e-6):
        """Differentiable log-probs of stored sampling transitions (one row
        per crystal and step): ``state`` holds ``timesteps [B]``,
        ``num_atoms [B]`` and the recorder's ``TRAJ_STATE_KEYS``. Evaluates
        the sampling-dtype net, as the recorder did. Returns (log_prob_l,
        log_prob_t, log_prob_x, (pred_l, pred_x of the corrector, pred_t))."""
        t = state["timesteps"].to(torch.long)
        k = self._coefs(t, step_lr)
        time_emb = sinusoidal_time_embedding(t, self.config.time_dim)
        num_atoms = state["num_atoms"]
        types, x, x_mid, lat = (state["atom_types"], state["frac_coords"],
                                state["frac_coords_mid"], state["lattices"])
        _, pred_x_corr, _ = self._eval_net(time_emb, types, x, lat, num_atoms, mask)
        x_mu_corr = (x - k["step_size"] * (pred_x_corr * k["sqrt_norm"])) % 1.0
        pred_l, pred_x, pred_t = self._eval_net(time_emb, types, x_mid, lat, num_atoms, mask)
        x_mu_pred = (x_mid - k["p_step"] * (pred_x * k["sqrt_norm"])) % 1.0
        mu_l = k["c0"] * (lat - k["c1"] * pred_l)
        mu_t = k["c0"] * (types - k["c1"] * pred_t)
        lp_l, lp_t, lp_x = self._transition_logprobs(
            k, mask, x_mid, x_mu_corr, state["next_frac_coords"], x_mu_pred,
            state["next_lattices"], mu_l, state["next_atom_types"], mu_t,
        )
        return lp_l, lp_t, lp_x, (pred_l, pred_x_corr, pred_t)

    # --------------------------------------------------------------- sampling
    @torch.no_grad()
    def sample(
        self,
        noise: CSPNoiseSource | torch.Generator,
        num_atoms: torch.Tensor,
        max_atoms: int | None = None,
        step_lr: float = 5e-6,
        record_traj: bool = False,
        fixed_lattice: torch.Tensor | None = None,
        fixed_coords: torch.Tensor | None = None,
    ):
        """Predictor-corrector ancestral sampling over t = T..1. Returns the
        final ``CrystalBatch`` (types the argmax of the logits, 1-based) and,
        with ``record_traj``, the trajectory: the transition states of
        ``TRAJ_STATE_KEYS`` ``[T, B, ...]``, ``log_prob_{l,t,x}`` ``[T, B]``
        and ``timestep`` ``[T]``; else None."""
        c = self.config
        if isinstance(noise, torch.Generator):
            noise = CSPGeneratorNoise(noise)
        A = int(max_atoms) if max_atoms is not None else 20
        num_atoms = torch.clamp(num_atoms.to(self.device), max=A)
        B, K, dev = num_atoms.shape[0], c.max_atomic_num, self.device
        mask = torch.arange(A, device=dev)[None, :] < num_atoms[:, None]
        x, l, tt = noise.prior(B, A, K, dev)
        if fixed_lattice is not None and not self.keep_lattice:
            raise ValueError("fixed_lattice passed but keep_lattice is off "
                             "(cost_lattice >= 1e-5); the fixed lattice would be ignored")
        if fixed_coords is not None and not self.keep_coords:
            raise ValueError("fixed_coords passed but keep_coords is off "
                             "(cost_coord >= 1e-5); the fixed coords would be ignored")
        if self.keep_lattice and fixed_lattice is None:
            raise ValueError("keep_lattice is on (cost_lattice < 1e-5) but no fixed_lattice was provided")
        if self.keep_coords and fixed_coords is None:
            raise ValueError("keep_coords is on (cost_coord < 1e-5) but no fixed_coords was provided")
        hold_l, hold_x = fixed_lattice is not None, fixed_coords is not None
        if hold_l:
            l = fixed_lattice.to(dev, torch.float32)
        if hold_x:
            x = fixed_coords.to(dev, torch.float32)

        rec: dict[str, list] = {}
        for i in range(c.timesteps):
            t = c.timesteps - i
            times = torch.full((B,), t, dtype=torch.long, device=dev)
            time_emb = sinusoidal_time_embedding(times, c.time_dim)
            k = self._coefs(times, step_lr)
            d = noise.step(i, B, A, K, dev)
            nz = 1.0 if t > 1 else 0.0

            # corrector: Langevin on the coords
            _, pred_x, _ = self._eval_net(time_emb, tt, x, l, num_atoms, mask)
            pred_x = pred_x * k["sqrt_norm"]
            x_half = x - k["step_size"] * pred_x + k["std_x"] * (nz * d.corr)
            if hold_x:
                x_half = x  # frozen coords: the corrector is a no-op
            x_mu_corr = (x - k["step_size"] * pred_x) % 1.0
            if record_traj:
                # the replay sees the wrapped coords: let the predictor too
                x_half = x_half % 1.0

            # predictor: ancestral DDPM on lattice and types, VE on coords
            pred_l, pred_x, pred_t = self._eval_net(time_emb, tt, x_half, l, num_atoms, mask)
            pred_x = pred_x * k["sqrt_norm"]
            x_next = (x_half - k["p_step"] * pred_x + k["p_std"] * (nz * d.coords)) % 1.0
            mu_l = k["c0"] * (l - k["c1"] * pred_l)
            mu_t = k["c0"] * (tt - k["c1"] * pred_t)
            l_next = mu_l + k["sigmas"] * (nz * d.lattice)
            t_next = mu_t + k["sigmas"] * (nz * d.types)
            if c.sample_clip is not None:
                l_next = torch.clamp(l_next, -c.sample_clip, c.sample_clip)
                t_next = torch.clamp(t_next, -c.sample_clip, c.sample_clip)
            if hold_l:
                l_next = l
            if hold_x:
                x_next = x

            if record_traj:
                x_mid = x_half % 1.0
                x_mu_pred = (x_half - k["p_step"] * pred_x) % 1.0
                lp_l, lp_t, lp_x = self._transition_logprobs(
                    k, mask, x_mid, x_mu_corr, x_next, x_mu_pred, l_next, mu_l, t_next, mu_t,
                )
                for key, v in (
                    ("log_prob_l", lp_l), ("log_prob_t", lp_t), ("log_prob_x", lp_x),
                    ("frac_coords", x), ("lattices", l), ("atom_types", tt),
                    ("frac_coords_mid", x_mid), ("next_frac_coords", x_next),
                    ("next_lattices", l_next), ("next_atom_types", t_next),
                ):
                    rec.setdefault(key, []).append(v)
            x, l, tt = x_next, l_next, t_next

        atom_types = torch.argmax(tt, dim=-1) + 1
        atom_types = torch.where(mask, atom_types, 0).to(torch.int32)
        final = CrystalBatch(atom_types=atom_types, frac_coords=x % 1.0, lattice=l,
                             num_atoms=num_atoms)
        if not record_traj:
            return final, None
        traj = {key: torch.stack(v) for key, v in rec.items()}
        traj["timestep"] = torch.arange(c.timesteps, 0, -1, device=dev)
        return final, traj
