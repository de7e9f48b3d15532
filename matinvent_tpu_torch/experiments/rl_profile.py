"""Where an RL iteration's device time goes on the card: ``torch.profiler``
over the fine-tune's chunks and over the sampler's grid steps.

    python -m matinvent_tpu_torch.experiments.rl_profile

Both run the ``rl_hhi_rich5`` start checkpoint (h256/L6) at the recipe's
shapes. The fine-tune part profiles one ``FinetuneStep`` epoch of a few
chunks over 16 crystals x 25 timesteps (the inputs of ``chip_smoke.py``'s
phase ``finetune``); the sampling part profiles 64 crystals in one bucket
(the recipe's sampling) over a few grid steps. Each part reports the wall
time per chunk or step (host clock around work ending in a synchronize),
the device time of its kernels from the profiler, the device's idle share
(one minus busy over wall) and the kernels that take the most device time.
Prints one JSON record.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from matinvent_tpu_torch.experiments.timing import card
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.mattergen.diffusion import NoiseDraws
from matinvent_tpu_torch.models.mattergen.sample import (
    NUM_ATOMS_DISTRIBUTIONS,
    MatterGenSampler,
    load_num_atoms_distributions,
)
from matinvent_tpu_torch.models.suite.mattergen import load_model
from matinvent_tpu_torch.parallel.train import FinetuneStep

ROOT = Path(__file__).resolve().parents[2]
START = ROOT / "experiments/results/pretrained_geneval_r5_r5_long_s120000_ema"
HIST = ROOT / "experiments/data/corpus_r5_num_atoms.json"
CRYSTALS, ACCUM, MAX_ATOMS = 16, 25, 20


def net_flops(num_atoms, cfg, vocab: int) -> float:
    """Flops of one score-net forward over crystals of ``num_atoms`` atoms:
    the real pairs' edge products (embedding and second edge layer), the
    per-atom products of every layer, the input embedding and the heads."""
    H, L, nf = cfg.hidden_dim, cfg.num_layers, cfg.num_freqs
    n = np.asarray(num_atoms, dtype=np.float64)
    per_layer = (n**2).sum() * 2 * H * (6 * nf + H) + n.sum() * 2 * 5 * H * H
    return float(L * per_layer + n.sum() * 2 * H * (H + cfg.time_dim + 3 + vocab))


def chunk_inputs(vocab: int, seed: int = 5):
    """16 crystals from the corpus_r5 histogram (random species and
    coordinates, cubic-ish cells of 15 A^3 per atom), rewards in [0, 1) and
    one chunk's draws (25 timesteps), all made by numpy from ``seed``."""
    load_num_atoms_distributions(str(HIST))
    rng = np.random.default_rng(seed)
    hist = NUM_ATOMS_DISTRIBUTIONS["corpus_r5"]
    na = np.clip(rng.choice(len(hist), CRYSTALS, p=hist / hist.sum()), 1, MAX_ATOMS)
    B, A = CRYSTALS, MAX_ATOMS
    mask = np.arange(A)[None, :] < na[:, None]
    edge = (15.0 * na) ** (1 / 3)
    lat = edge[:, None, None] * (np.eye(3) + 0.1 * rng.normal(size=(B, 3, 3)))
    batch = CrystalBatch(
        torch.tensor(np.where(mask, rng.integers(1, 101, (B, A)), 0), dtype=torch.int32),
        torch.tensor(rng.uniform(size=(B, A, 3)) * mask[..., None], dtype=torch.float32),
        torch.tensor(lat, dtype=torch.float32),
        torch.tensor(na, dtype=torch.int32),
    )
    rewards = torch.tensor(rng.uniform(size=B), dtype=torch.float32)
    draws = NoiseDraws(
        torch.tensor(rng.normal(size=(ACCUM, B, 3, 3)), dtype=torch.float32),
        torch.tensor(rng.normal(size=(ACCUM, B, A, 3)), dtype=torch.float32),
        torch.tensor(rng.gumbel(size=(ACCUM, B, A, vocab)), dtype=torch.float32),
    )
    return batch, rewards, draws


def _profiled(fn, units: int, top: int = 12) -> dict:
    """Run ``fn`` once timed and once under the profiler: wall ms per unit
    (the timed run), device ms per unit (the profiled run's kernels), the
    idle share of the timed run, and the kernels with the most device time.
    The profiler slows the host, not the kernels."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    # device work only: the optimizer's ``record_function`` range is a
    # device event too, spanning kernels already counted
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, list] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return dict(
        wall_ms=1e3 * wall / units,
        device_ms=busy_us / 1e3 / units,
        idle_share=1.0 - busy_us / 1e6 / wall,
        kernel_launches=len(kernels) / units,
        top=[dict(name=n[:120], calls=c / units, device_ms=t / 1e3 / units,
                  share=t / max(busy_us, 1e-9)) for n, (c, t) in ranked],
    )


def profile_finetune(device: str = "cuda", chunks: int = 4) -> dict:
    agent = load_model(START, device=device)
    prior = load_model(START, device=device).requires_grad_(False)
    batch, rewards, _ = chunk_inputs(agent.d3pm.vocab)
    batch, rewards = batch.to(device), rewards.to(device)
    step = FinetuneStep(lr=1e-4, timesteps=chunks * ACCUM, accum_steps=ACCUM, sigma_kl=0.1,
                        epochs=1)
    opt = step.optimizer(agent)
    gen = torch.Generator(device=device).manual_seed(0)
    step.epoch(agent, opt, prior, batch, rewards, generator=gen)  # warm-up
    rec = _profiled(lambda: step.epoch(agent, opt, prior, batch, rewards, generator=gen), chunks)
    flops = 4 * ACCUM * net_flops(batch.num_atoms.cpu().numpy(), agent.config, agent.d3pm.vocab)
    return dict(rec, chunks=chunks, crystals=CRYSTALS, accum_steps=ACCUM,
                chunk_tflop=flops / 1e12, peak_memory_bytes=torch.cuda.max_memory_allocated())


def profile_sampling(device: str = "cuda", steps: int = 20, batch: int = 64) -> dict:
    # T sets the grid, not the work of a step: a short grid profiles steps
    model = load_model(START, device=device, config_overrides={"timesteps": steps})
    sampler = MatterGenSampler(batch_size=batch, num_batches=1, max_atoms=MAX_ATOMS,
                               num_atoms_distribution="corpus_r5",
                               num_atoms_distribution_file=str(HIST), seed=0)
    sampler.launch(model)  # warm-up
    rec = _profiled(lambda: sampler.launch(model), steps)
    return dict(rec, steps=steps, crystals=batch, buckets=1)


def main(device: str = "cuda") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("rl_profile measures the card: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = dict(experiment="rl_profile", device=card(),
               finetune=profile_finetune(device), sampling=profile_sampling(device))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
