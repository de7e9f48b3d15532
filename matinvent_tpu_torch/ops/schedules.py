"""Diffusion noise schedules as precomputed tables (``matinvent_tpu/ops/schedules.py``).

The tables are zero-prefixed, length ``T + 1``, so index ``t`` in 1..T
addresses timestep t: ``betas[0] = 0``, ``sigmas[0] = 0``,
``sigmas_norm[0] = 1``. They are built in numpy as the JAX package builds
them and rounded once to float32.

``SigmaSchedule.sigmas_norm`` is a Monte-Carlo estimate of E[score^2] over
draws that the JAX package makes with ``jax.random.normal(PRNGKey(seed))``.
The port makes the same draws: ``threefry2x32`` below is JAX's counter-based
generator (the partitionable layout, JAX's default), ``jax_normal`` its
float32 normal (uniform bits in ``(-1, 1)``, then ``sqrt(2) erfinv`` with
XLA's float32 polynomial). The draws and scores are float32 as in JAX; the
mean is summed in float64, which XLA's tree reduction approaches more
closely than a float32 running sum. The normals differ from JAX's by a few
ulps where XLA's ``log1p`` does, and the mean by the summation order: the
normalizers agree to about 1e-6 relative where they are not rounding noise
(``tests/test_torch_port_diffcsp.py``).
"""
from __future__ import annotations

import functools
import logging
import math
from dataclasses import dataclass

import numpy as np
import torch

from matinvent_tpu_torch.ops.wrapped_normal import d_log_p_wrapped_normal_np


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule (Nichol & Dhariwal, arXiv:2102.09672)."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0001, 0.9999)


def linear_beta_schedule(timesteps: int, beta_start: float, beta_end: float) -> np.ndarray:
    return np.linspace(beta_start, beta_end, timesteps)


def quadratic_beta_schedule(timesteps: int, beta_start: float, beta_end: float) -> np.ndarray:
    return np.linspace(beta_start**0.5, beta_end**0.5, timesteps) ** 2


def sigmoid_beta_schedule(timesteps: int, beta_start: float, beta_end: float) -> np.ndarray:
    betas = np.linspace(-6, 6, timesteps)
    return 1.0 / (1.0 + np.exp(-betas)) * (beta_end - beta_start) + beta_start


def _f32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def uniform_sample_t(generator: torch.Generator, batch_size: int, timesteps: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Integer timesteps drawn uniformly from 1..T."""
    return torch.randint(1, timesteps + 1, (batch_size,), generator=generator, device=device)


@dataclass(frozen=True)
class BetaSchedule:
    """DDPM/VP schedule tables ``[T+1]`` (float32, on the CPU)."""

    timesteps: int
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sigmas: torch.Tensor  # posterior std sqrt(beta_t (1-abar_{t-1})/(1-abar_t))

    @classmethod
    def create(
        cls,
        timesteps: int,
        scheduler_mode: str = "cosine",
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
    ) -> "BetaSchedule":
        if scheduler_mode == "cosine":
            betas = cosine_beta_schedule(timesteps)
        elif scheduler_mode == "linear":
            betas = linear_beta_schedule(timesteps, beta_start, beta_end)
        elif scheduler_mode == "quadratic":
            betas = quadratic_beta_schedule(timesteps, beta_start, beta_end)
        elif scheduler_mode == "sigmoid":
            betas = sigmoid_beta_schedule(timesteps, beta_start, beta_end)
        else:
            raise ValueError(f"unknown scheduler_mode: {scheduler_mode}")
        betas = np.concatenate([np.zeros(1), betas])
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        sigmas = np.zeros_like(betas)
        sigmas[1:] = betas[1:] * (1.0 - alphas_cumprod[:-1]) / (1.0 - alphas_cumprod[1:])
        sigmas = np.sqrt(sigmas)
        if betas[-1] > 0.9 and timesteps < 200:
            # the clip-saturated cosine tail makes the first reverse step a
            # large error amplifier, which short chains do not re-contract
            logging.warning(
                f"beta schedule ({scheduler_mode}, T={timesteps}) saturates "
                f"at beta_T={float(betas[-1]):.4f}; ancestral sampling is "
                f"numerically unstable below ~200 steps: use T >= 200 "
                f"(reference operating point: 1000) or a linear schedule"
            )
        return cls(timesteps, _f32(betas), _f32(alphas), _f32(alphas_cumprod), _f32(sigmas))

    def uniform_sample_t(self, generator: torch.Generator, batch_size: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
        return uniform_sample_t(generator, batch_size, self.timesteps, device)


@dataclass(frozen=True)
class SigmaSchedule:
    """VE schedule of the wrapped-normal coords: ``sigmas`` zero-prefixed,
    ``sigmas_norm`` the one-prefixed E[score^2] normalizers ``[T+1]``."""

    timesteps: int
    sigma_begin: float
    sigma_end: float
    sigmas: torch.Tensor
    sigmas_norm: torch.Tensor

    @classmethod
    def create(
        cls,
        timesteps: int,
        sigma_begin: float = 0.01,
        sigma_end: float = 1.0,
        seed: int = 0,
        num_mc_samples: int = 10000,
    ) -> "SigmaSchedule":
        sigmas = np.exp(
            np.linspace(np.log(sigma_begin), np.log(sigma_end), timesteps)
        ).astype(np.float32)
        norm = sigma_norm(sigmas.tobytes(), seed, num_mc_samples)
        return cls(
            timesteps, sigma_begin, sigma_end,
            _f32(np.concatenate([np.zeros(1, np.float32), sigmas])),
            _f32(np.concatenate([np.ones(1, np.float32), norm])),
        )

    def uniform_sample_t(self, generator: torch.Generator, batch_size: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
        return uniform_sample_t(generator, batch_size, self.timesteps, device)


# ----------------------------------------------------------- JAX's draws

_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as ``jax.random``
    computes it: the key ``(k0, k1)`` applied to the counter words."""
    ks = [_U32(key[0]), _U32(key[1]), _U32(key[0]) ^ _U32(key[1]) ^ _U32(0x1BD11BDA)]
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for r in range(5):
            for rot in rotations[r % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, rot) ^ x0
            x0 = x0 + ks[(r + 1) % 3]
            x1 = x1 + ks[(r + 2) % 3] + _U32(r + 1)
    return x0, x1


def jax_random_bits(key: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32, partitionable layout): the
    counter of each element is its row-major index as (high, low) words."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


# XLA's float32 erfinv (Giles' polynomial), highest coefficient first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    w = -np.log1p(x * -x)
    lt = w < f32(5.0)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0])).astype(f32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, f32(a), f32(b)).astype(f32) + p * w
    out = p * x
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max, out).astype(f32)


def jax_normal(key: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32."""
    f32 = np.float32
    bits = jax_random_bits(key, shape)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(f32) - f32(1.0)
    lo = np.nextafter(f32(-1.0), f32(0.0), dtype=f32)
    u = np.maximum(lo, floats * (f32(1.0) - lo) + lo)
    return f32(np.sqrt(2)) * _erfinv_f32(u)


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as its two words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


@functools.lru_cache(maxsize=8)
def sigma_norm(sigmas_bytes: bytes, seed: int = 0, num_samples: int = 10000) -> np.ndarray:
    """Monte-Carlo E[(d log p)^2] under x ~ WN(0, sigma) per float32 sigma
    (``sigmas_bytes``, the buffer of a float32 array), on JAX's draws from
    ``PRNGKey(seed)``; float32 ``[T]``."""
    sigmas = np.frombuffer(sigmas_bytes, dtype=np.float32)
    T = sigmas.shape[0]
    key = prng_key(seed)
    z = jax_normal(key, (num_samples, T))
    total = np.zeros(T, np.float64)
    # blocks of draws keep the temporaries small
    step = max(1, min(num_samples, 2_000_000 // max(T, 1)))
    for s in range(0, num_samples, step):
        x = np.remainder(sigmas * z[s:s + step], np.float32(1.0))
        score = d_log_p_wrapped_normal_np(x, np.broadcast_to(sigmas, x.shape))
        total += np.sum((score * score).astype(np.float64), axis=0)
    return (total / num_samples).astype(np.float32)
