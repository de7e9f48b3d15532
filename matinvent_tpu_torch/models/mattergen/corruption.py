"""Corruption processes of MatterGen-class joint diffusion
(``matinvent_tpu/models/mattergen/corruption.py``).

* ``LatticeVPSDE``: variance-preserving SDE on the 3x3 cell, with the
  limiting std scaled per crystal by its atom count;
* ``WrappedCoordVE``: variance-exploding wrapped-normal corruption of
  fractional coordinates;
* ``TypeD3PM``: discrete D3PM chain over atom types (uniform or absorbing).

Random draws are not made here: the sampler and ``add_noise`` pass them in
(normal draws for the cell and the coordinates, a standard Gumbel draw for the
types, since ``jax.random.categorical`` is ``argmax(logits + gumbel)``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from matinvent_tpu_torch.ops.segment import graph_mean
from matinvent_tpu_torch.ops.wrapped_normal import d_log_p_wrapped_normal


@dataclass(frozen=True)
class LatticeVPSDE:
    """VP SDE ``dx = -0.5 beta(t) x dt + sqrt(beta(t)) dW`` on cell matrices,
    ``beta(t) = beta_min + t (beta_max - beta_min)``."""

    beta_min: float = 0.1
    beta_max: float = 20.0
    limit_density: float = 0.05

    def _B(self, t: torch.Tensor) -> torch.Tensor:
        return t * self.beta_min + 0.5 * t**2 * (self.beta_max - self.beta_min)

    def beta(self, t: torch.Tensor) -> torch.Tensor:
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def limit_std(self, num_atoms: torch.Tensor) -> torch.Tensor:
        """``[B]`` per-crystal limiting std ``(n / limit_density)^(1/3) / sqrt(3)``."""
        n = torch.clamp(num_atoms.to(torch.float32), min=1.0)
        return (n / self.limit_density) ** (1.0 / 3.0) / math.sqrt(3.0)

    def marginal(self, x0: torch.Tensor, t: torch.Tensor, num_atoms: torch.Tensor):
        """(mean ``[B,3,3]``, std ``[B,1,1]``) of the marginal at time t."""
        B_t = self._B(t)[:, None, None]
        mean = x0 * torch.exp(-0.5 * B_t)
        sigma_lim = self.limit_std(num_atoms)[:, None, None]
        std = sigma_lim * torch.sqrt(1.0 - torch.exp(-B_t))
        return mean, std

    def sample_marginal(self, x0, t, num_atoms, eps: torch.Tensor):
        """(x_t, eps, std) for the standard normal draw ``eps [B, 3, 3]``."""
        mean, std = self.marginal(x0, t, num_atoms)
        return mean + std * eps, eps, std

    def prior_sample(self, z: torch.Tensor, num_atoms: torch.Tensor) -> torch.Tensor:
        """Prior cell from a standard normal draw ``z [B, 3, 3]``."""
        return self.limit_std(num_atoms)[:, None, None] * z


@dataclass(frozen=True)
class WrappedCoordVE:
    """VE wrapped-normal corruption of fractional coords (period 1)."""

    sigma_min: float = 0.005
    sigma_max: float = 0.5

    def sigma(self, t: torch.Tensor) -> torch.Tensor:
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def sample_marginal(self, x0, t, eps: torch.Tensor):
        """(x_t wrapped, eps, sigma ``[B,1,1]``) for the standard normal draw
        ``eps [B, A, 3]``."""
        sigma = self.sigma(t)[:, None, None]
        return (x0 + sigma * eps) % 1.0, eps, sigma

    def score_target(self, eps: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """Wrapped-normal score at the sampled offset (reference convention)."""
        return d_log_p_wrapped_normal(sigma * eps, sigma)

    def prior_sample(self, u: torch.Tensor) -> torch.Tensor:
        """Prior coords: the uniform draw ``u [B, A, 3]`` itself."""
        return u


def _d3pm_tables(
    num_steps: int, beta_min: float = 1e-3, beta_max: float = 0.999
) -> tuple[np.ndarray, np.ndarray]:
    """(betas ``[N+1]``, abar ``[N+1]``) of the linear D3PM schedule; index 0
    is the identity."""
    betas = np.concatenate([np.zeros(1), np.linspace(beta_min, beta_max, num_steps)])
    abar = np.cumprod(1.0 - betas)
    return betas, abar


@dataclass(frozen=True)
class TypeD3PM:
    """Discrete D3PM chain over atom types.

    ``kind='uniform'`` mixes toward the uniform distribution over K classes;
    ``kind='absorbing'`` toward a MASK class (index K, so logits have K+1
    classes).
    """

    num_classes: int
    num_steps: int
    kind: str
    betas: torch.Tensor  # [N+1] f32
    abar: torch.Tensor  # [N+1] f32

    @classmethod
    def create(
        cls, num_classes: int = 100, num_steps: int = 1000, kind: str = "uniform",
        device: torch.device | str = "cpu",
    ) -> "TypeD3PM":
        if kind not in ("uniform", "absorbing"):
            raise ValueError(f"unknown D3PM kind {kind!r}")
        betas, abar = _d3pm_tables(num_steps)
        return cls(
            num_classes=num_classes,
            num_steps=num_steps,
            kind=kind,
            betas=torch.as_tensor(betas, dtype=torch.float32, device=device),
            abar=torch.as_tensor(abar, dtype=torch.float32, device=device),
        )

    @property
    def vocab(self) -> int:
        return self.num_classes + (1 if self.kind == "absorbing" else 0)

    def _t_index(self, t: torch.Tensor) -> torch.Tensor:
        """Continuous t in (0, 1] -> step index in 1..N, rounded to nearest
        (the sampler's grid lies exactly on ceil's discontinuities)."""
        return torch.clamp(
            torch.floor(t * self.num_steps + 0.5).to(torch.long), 1, self.num_steps
        )

    def _mask_onehot(self, like: torch.Tensor) -> torch.Tensor:
        oh = torch.zeros(self.vocab, dtype=like.dtype, device=like.device)
        oh[-1] = 1.0
        return oh

    def q_t_given_0(self, x0_onehot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Marginal q(x_t | x_0) probabilities ``[B, A, V]``."""
        a = self.abar[self._t_index(t)][:, None, None]
        if self.kind == "uniform":
            return a * x0_onehot + (1.0 - a) / self.vocab
        return a * x0_onehot + (1.0 - a) * self._mask_onehot(x0_onehot)

    def sample_marginal(
        self, x0: torch.Tensor, t: torch.Tensor, gumbel: torch.Tensor
    ) -> torch.Tensor:
        """x_t ``[B, A]`` (0-based classes) given x0 ``[B, A]`` and a standard
        Gumbel draw ``[B, A, V]``."""
        oh = F.one_hot(x0.long(), self.vocab).to(torch.float32)
        probs = self.q_t_given_0(oh, t)
        return torch.argmax(torch.log(torch.clamp(probs, min=1e-20)) + gumbel, dim=-1)

    def posterior_logits(
        self, x_t: torch.Tensor, x0_logits: torch.Tensor, t: torch.Tensor
    ) -> torch.Tensor:
        """log q(x_{t-1} | x_t, p(x0)) for the reverse ancestral step, with the
        model's x0 distribution mixed in. ``x_t [B, A]``, ``x0_logits
        [B, A, V]``, ``t [B]``."""
        ti = self._t_index(t)
        beta_t = self.betas[ti][:, None, None]
        abar_prev = self.abar[torch.clamp(ti - 1, min=0)][:, None, None]

        x0_probs = torch.softmax(x0_logits, dim=-1)
        xt_oh = F.one_hot(x_t.long(), self.vocab).to(x0_logits.dtype)

        if self.kind == "uniform":
            uniform = 1.0 / self.vocab
            # q(x_t | x_{t-1}) as a function of x_{t-1}
            fact1 = (1.0 - beta_t) * xt_oh + beta_t * uniform
            # q(x_{t-1} | x0) under the model's x0 distribution
            fact2 = abar_prev * x0_probs + (1.0 - abar_prev) * uniform
        else:
            mask_oh = self._mask_onehot(x0_logits)
            xt_is_mask = torch.sum(xt_oh * mask_oh, -1, keepdim=True)  # [B, A, 1]
            fact1 = (1.0 - beta_t) * xt_oh + beta_t * xt_is_mask
            fact2 = abar_prev * x0_probs + (1.0 - abar_prev) * mask_oh

        out = torch.log(torch.clamp(fact1, min=1e-20)) + torch.log(
            torch.clamp(fact2, min=1e-20)
        )
        # at step index 1 the posterior collapses to the model's x0 prediction
        t_is_one = (ti == 1)[:, None, None]
        return torch.where(t_is_one, torch.log(torch.clamp(x0_probs, min=1e-20)), out)

    def prior_sample(self, draw: torch.Tensor) -> torch.Tensor:
        """Prior classes ``[B, A]``: the uniform integer draw in ``[0, vocab)``
        for the uniform kind, all MASK for the absorbing kind."""
        if self.kind == "uniform":
            return draw.long()
        return torch.full_like(draw, self.vocab - 1, dtype=torch.long)

    def hybrid_loss(
        self,
        x0: torch.Tensor,  # [B, A] int
        x_t: torch.Tensor,  # [B, A] int
        x0_logits: torch.Tensor,  # [B, A, V]
        t: torch.Tensor,  # [B]
        mask: torch.Tensor,  # [B, A]
        hybrid_lambda: float = 0.01,
    ) -> torch.Tensor:
        """Per-crystal D3PM hybrid loss ``[B]``: the KL between the true and
        the model posteriors at t plus ``hybrid_lambda`` times the x0
        cross-entropy, averaged over the real atoms."""
        oh = F.one_hot(x0.long(), self.vocab).to(x0_logits.dtype)
        true_post = self.posterior_logits(x_t, torch.log(oh + 1e-20), t)
        model_post = self.posterior_logits(x_t, x0_logits, t)
        p = torch.softmax(true_post, dim=-1)
        kl = torch.sum(
            p * (F.log_softmax(true_post, -1) - F.log_softmax(model_post, -1)), dim=-1
        )
        ce = -torch.gather(F.log_softmax(x0_logits, -1), -1, x0.long()[..., None])[..., 0]
        return graph_mean(kl + hybrid_lambda * ce, mask)
