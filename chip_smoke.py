"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``matinvent_tpu_torch/csrc`` with
``nvcc`` (one process per source, in parallel) and holds each against its
plain PyTorch version. Then it drives the port's paths, each with the
launch counts set to 0 just before and read just after:

* the fused-edge harnesses (``python -m
  matinvent_tpu_torch.experiments.fused_edge_ab`` / ``fused_edge_flat``,
  phase ``edge_ablation``) at their full width, which launch the ablation
  modes of the edge kernel, the flat edge MLP and the precomputed-embedding
  kernel;
* sampling, in f32 and then in bf16 (the checkpoint loaded with
  ``sample_dtype`` bfloat16): the full-width ``rl_hhi_rich5`` score net
  through both edge paths (phase ``score_net``), then 256 crystals at
  T=1000 through the user entry point (``MatterGenSampler`` ->
  ``MatterGenDiffusion.sample_bucketed``), which launches the edge kernel,
  beside the plain edge path (phase ``sampling``);
* the fine-tune (phase ``finetune``): one chunk of ``rl_chunk_loss`` at full
  width on the ``rl_hhi_rich5`` start checkpoint (16 crystals x 25
  timesteps, draws made by numpy), its loss and gradients held against the
  same code on the CPU, then one ``FinetuneStep`` epoch timed per chunk;
* the sampler's validity (phase ``validity``): 512 crystals of the start
  checkpoint at T=1000 through the kernel, their SMACT, structural and
  cell-size failure shares held against the JAX package's record in
  ``experiments/results/validity_curve_r5.json``;
* the sample filter's metrics (phase ``opt_filter``): ``OptEval`` with the
  exact disordered matcher on those 512 crystals against the 36,000
  structures of ``experiments/data/corpus_r5.extxyz``, and the native fit
  (``csrc/structure_fit.cpp``) against its plain version on 64 of them;
* two RL iterations of the ``rl_hhi_rich5`` recipe, built by the entry
  point ``matinvent_tpu_torch.pipeline.mat_invent`` (``resolve``, ``build``)
  (phase ``rl``): iteration 0 by ``run_rl``, which saves the run state,
  then iteration 1 by a fresh ``MatInvent`` resumed from it: sample,
  filter, HHI reward, memory and replay, fine-tune; 12,000 kernel launches
  in each iteration's sampling;
* two iterations of the same recipe with ``async_sampling`` (phase
  ``rl_async``): iteration 1's batch is sampled in the sampling thread
  while the host scores iteration 0;
* the device-side reward models (phase ``predictor``): the six in-repo
  property predictors, their ten tasks and SynScore on the card, held
  against the JAX package's values
  (``matinvent_tpu_torch/experiments/results/reward_models_jax.json``),
  their time per call at batch 64 and 512, and 20 ``PredictorTrainer``
  steps at full width, the first against the CPU;
* two RL iterations of the ``rl_mag_rich_dense`` recipe (phase
  ``rl_mag``), rewarded by the magnetic-density predictor on the card;
* the DiffCSP family (phase ``diffcsp``): the in-repo checkpoint
  ``experiments/results/pretrained`` loaded by ``DiffCSPSuite``, its f32
  score net on the card against the CPU, 128 crystals sampled at T=1000
  (``max_atoms`` 8, ``sample_clip`` 30) with their validity shares, and one
  reward-weighted iteration of the ``diffcsp_hhi`` recipe;
* DDPO (phases ``ddpo_diffcsp`` and ``ddpo_mattergen``): two iterations of
  ``rl_hhi_ddpo`` and of ``rl_hhi_ddpo_mattergen_t1000``; in iteration 0
  the replay of the recorded trajectory at the recording weights must give
  a mean importance ratio of 1 within 1e-5 and no clipped ratio, and each
  PPO epoch's ratio statistics are reported. These phases run the plain
  net (DiffCSP's ``CSPNet`` has no fused edge branch, and DDPO records and
  replays on the plain net), so they launch none of the kernels: the count
  is read and must stay 0.

Kernel times are device times (CUDA graph replay, ``experiments/timing.py``).
Each phase prints one JSON line (the harnesses print their own records
too); the line before the last is the ``{"kernels": [...]}`` record and the
last line is ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that line. It needs one CUDA card;
without one it exits non-zero at once. It writes the kernel builds
(``matinvent_tpu_torch/_build/``) and, for phases ``rl`` and ``rl_async``,
temporary directories that it removes.
"""
from __future__ import annotations

import ctypes
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from matinvent_tpu_torch.chem.matcher import (
    DisorderedExactStructureMatcher,
    DisorderedStructureMatcher,
)
from matinvent_tpu_torch.chem.proxy_labels import label_structures
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz
from matinvent_tpu_torch.chem.validity import cell_size_ok, smact_valid, structure_validity
from matinvent_tpu_torch.csrc.build import build, build_host
from matinvent_tpu_torch.experiments import fused_edge_ab, fused_edge_flat
from matinvent_tpu_torch.experiments.rl_profile import chunk_inputs, net_flops
from matinvent_tpu_torch.experiments.timing import (
    PEAK_ROUTE,
    bound_ms,
    eager_ms,
    nbytes,
    time_ms,
)
from matinvent_tpu_torch.models.cspnet import sinusoids_embedding
from matinvent_tpu_torch.models.mattergen.diffusion import MGNoised, NoiseDraws
from matinvent_tpu_torch.models.diffcsp import NoisedInput, sinusoidal_time_embedding
from matinvent_tpu_torch.models.mattergen.sample import MatterGenSampler
from matinvent_tpu_torch.models.sample import DiffCSPSampler, batch_to_structures
from matinvent_tpu_torch.models.suite.diffcsp import DiffCSPSuite
from matinvent_tpu_torch.models.suite.mattergen import load_model
from matinvent_tpu_torch.ops.fused_edge import fused_edge_chain, fused_edge_chain_plain
from matinvent_tpu_torch.parallel.train import FinetuneStep
from matinvent_tpu_torch.parallel.train_predictor import PredictorTrainer, labeled_batches
from matinvent_tpu_torch.pipeline import mat_invent
from matinvent_tpu_torch.pipeline.filters import OptEval, ReferenceDataset
from matinvent_tpu_torch.rewards.calculators import PropertyPredictor, SynScore
from matinvent_tpu_torch.rewards.calculators.predictor import TASK_MODEL_DICT, PropertyGNN
from matinvent_tpu_torch.utils.checkpoint import load_run_state

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "experiments/results/rl_hhi_rich5/models/final"
# the rl_hhi_rich5 run's start checkpoint and num-atoms histogram
START = ROOT / "experiments/results/pretrained_geneval_r5_r5_long_s120000_ema"
HIST = ROOT / "experiments/data/corpus_r5_num_atoms.json"
RL_METRICS = ROOT / "experiments/results/rl_hhi_rich5/metrics.csv"
# the JAX package's validity of START: experiments/results/validity_curve_r5.json,
# 512 crystals, corpus_r5 histogram, 4 buckets, seed 1
VALIDITY_RECORD = {"smact_fail": 0.2988, "structural_fail": 0.0234, "cell_fail": 0.0,
                   "all_ok": 0.6875, "n": 512}
VALIDITY_BATCH, VALIDITY_SEED = 512, 1
# phase opt_filter: the novelty reference and hull, the JAX package's
# (relaxed) record, and the native-against-plain gate's sizes
CORPUS = ROOT / "experiments/data/corpus_r5.extxyz"
CORPUS_ENERGIES = ROOT / "experiments/data/corpus_r5_energies.json"
GEN_EVAL_RECORD = ROOT / "experiments/results/gen_eval_1024_r5_metrics.json"
GATE_N, GATE_REF = 64, 1000
# the fine-tune chunk (16 crystals x 25 timesteps, rl_profile.chunk_inputs)
# at grid indices 500..524, the recipe's lr and KL weight
FT_CHUNK, FT_LR, FT_SIGMA = 20, 1e-4, 0.1
# phase predictor: the JAX package's values on the corpus head and the
# degenerate structures; card against JAX: each model within 1e-4 of its
# y_std (TF32 off), SynScore within 1e-6
REWARD_RECORD = ROOT / "matinvent_tpu_torch/experiments/results/reward_models_jax.json"
PRED_TOL, SYN_TOL = 1e-4, 1e-6
PRED_BATCHES, PRED_REPEATS = (64, 512), 7
# the trainer: 20 steps at H=128/L=4, batch 64, proxy labels of the corpus
TRAIN_STEPS, TRAIN_BATCH, TRAIN_MODEL = 20, 64, "mp_total_mag_per_atom"
RL_MAG_METRICS = ROOT / "experiments/results/rl_mag_rich_dense/metrics.csv"
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
# the DiffCSP family: the in-repo checkpoint, sampled as the DDPO recipes
# sample it (128 crystals of at most 8 atoms, sample_clip 30); its score
# net card against CPU within 2e-4 of scale (the f32 score-net line)
DIFFCSP_CKPT = ROOT / "experiments/results/pretrained"
DIFFCSP_BATCH, DIFFCSP_MAX_ATOMS, DIFFCSP_CLIP, NET_TOL = 128, 8, 30.0, 2e-4
# DDPO: the replay at the recording weights, mean ratio within 1e-5 of 1
RATIO_TOL = 1e-5
DEV = "cuda"
BATCH, BUCKETS, MAX_ATOMS, SEED = 256, 4, 20, 0
SOURCES = ("fused_edge", "edge_flat")  # csrc/<name>.cu
HOST_SOURCES = ("charge_balance", "structure_fit")  # csrc/<name>.cpp, g++
# (crystals, cap) of the harness kernels' checks: the harnesses' full width
# (bench.py's dominant bucket) and an odd shape (81,200 and 1,183 flat rows)
EDGE_SHAPES = [(203, 20), (7, 13)]
# kernel vs plain version: f32 differs only by summation order (1e-4 of the
# output's scale); bf16 rounds e to bf16 before the second product, and one
# flipped rounding moves an output by about one bf16 step (2^-6 of scale)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def edge_inputs(B: int, A: int, H: int, nf: int, dtype, gen, num_atoms=None):
    """Random fused_edge_chain inputs on the card; ``num_atoms`` [B] sets the
    padding (random in 1..A when omitted)."""
    dev = DEV
    if num_atoms is None:
        num_atoms = torch.randint(1, A + 1, (B,), generator=gen, device=dev)
    mask = torch.arange(A, device=dev)[None, :] < num_atoms[:, None]
    m = mask.to(torch.float32)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    args = (
        rnd(B, A, H), rnd(B, A, H),
        torch.rand((B, A, 3), generator=gen, device=dev),
        (m / num_atoms[:, None].to(torch.float32))[..., None].contiguous(),
        m[..., None].contiguous(),
        rnd(6 * nf, H, scale=0.1), rnd(H, H, scale=0.1), rnd(H, scale=0.1),
    )
    return args, mask


def check_kernel(args, mask, nf: int) -> float:
    """Max |kernel - plain| on one input; raises past the tolerance or when a
    padded row is not exactly 0."""
    out = fused_edge_chain(*args, num_freqs=nf)
    torch.cuda.synchronize()
    ref = fused_edge_chain_plain(*args, num_freqs=nf)
    return check_close(out, ref, f"{tuple(args[0].shape)} {args[0].dtype}", mask)


def check_close(out, ref, what: str, mask=None) -> float:
    """Max |kernel - plain|; raises past ``TOL`` of the output's scale, on a
    non-finite output, or when a padded row (``mask`` false) is not
    exactly 0."""
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[out.dtype] * max(1.0, ref.float().abs().max().item())
    if err > tol:
        raise AssertionError(f"{what}: kernel vs plain {err} > {tol}")
    if mask is not None and (out[~mask] != 0).any():
        raise AssertionError(f"{what}: padded rows not exactly 0")
    return err


def bound(args, num_atoms, nf: int) -> tuple[float, str]:
    """Least time (ms) for one call: bytes of the inputs read once and the
    output written once over the memory rate, against the flops the real
    (i, j) pairs need over the peak of the dtype's route (PEAK_ROUTE);
    whichever is larger."""
    H = args[0].shape[-1]
    pairs = float((num_atoms.to(torch.float64) ** 2).sum().item())
    flops = 2.0 * pairs * (6 * nf * H + H * H)
    return bound_ms(nbytes(*args) + nbytes(args[0]), flops, args[0].dtype)


def library_chain(args, nf: int) -> torch.Tensor:
    """``fused_edge_chain``'s function as a chain of PyTorch ops (cuBLAS
    products), the yardstick of its time; the port never calls it."""
    ti, tj, fr, ui, uj, wd, w1, b1 = args
    fd = (fr[:, None, :, :] - fr[:, :, None, :]) % 1.0
    dist = sinusoids_embedding(fd, nf).to(ti.dtype)
    return fused_edge_ab.chain_from_emb(ti, tj, dist, ui, uj, wd, w1, b1)


def phase_device() -> dict:
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rec = dict(
        phase="device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=smi,
        seconds=time.perf_counter() - t0,
    )
    emit(rec)
    return rec


# the template arguments of fused_edge.cu's instances, as mangled by nvcc
_EDGE_INSTANCE = re.compile(
    r"fused_edge_kernelI(13__nv_bfloat16|f)Li(\d+)ELNS_3EmbE(\d)ELb(\d)ELb(\d)E"
)
# (embedding source, broadcast add, j-sum) -> mode of fused_edge_launch
_EDGE_MODE = {("0", "1", "1"): "full", ("1", "1", "1"): "nosin", ("0", "0", "0"): "nobcast",
              ("0", "1", "0"): "noagg", ("1", "0", "0"): "gemmonly", ("2", "1", "1"): "demb"}


def instance_name(mangled: str) -> str:
    """``fused_edge <mode> <dtype> H=<H>``, ``edge_flat bf16 H=256``, or the
    mangled name of an instance nvcc reported."""
    m = _EDGE_INSTANCE.search(mangled)
    if m:
        dtype = "bf16" if m.group(1) != "f" else "f32"
        return f"fused_edge {_EDGE_MODE[m.group(3, 4, 5)]} {dtype} H={m.group(2)}"
    m = re.search(r"edge_flat_kernelILi(\d+)E", mangled)
    return f"edge_flat bf16 H={m.group(1)}" if m else mangled


def ptxas_report(log: str, smem_bytes) -> list[dict]:
    """Per kernel instance, from nvcc's ``-Xptxas -v`` output: registers,
    spill bytes and static shared memory, and the dynamic shared memory
    that ``smem_bytes(name)`` gives for it."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = dict(instance=instance_name(ln.split("'")[1]))
            out.append(cur)
        elif cur is not None and "spill" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            cur["spill_bytes"] = int(st) + int(ld)
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem_static"] = int(m.group(1)) if m else 0
            cur["smem_dynamic"] = smem_bytes(cur["instance"])
    return out


def _smem_query(name: str, lib):
    """Dynamic shared memory per block of an instance, from the library."""
    if name == "edge_flat":
        return lambda inst: lib.edge_flat_smem_bytes()
    lib.fused_edge_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lambda inst: lib.fused_edge_smem_bytes(
        int(inst.rsplit("H=", 1)[1]), int(" bf16 " in inst)
    )


def phase_build() -> dict:
    """Builds every source at once, one nvcc each; every instance must
    compile without spills."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + len(HOST_SOURCES)) as pool:
        hosts = [pool.submit(build_host, name) for name in HOST_SOURCES]
        built = dict(zip(SOURCES, pool.map(build, SOURCES)))
        hosts = dict(zip(HOST_SOURCES, (h.result() for h in hosts)))
    libraries = {
        name: dict(library=str(b.path.relative_to(ROOT)), nvcc_seconds=b.seconds,
                   instances=ptxas_report(b.log, _smem_query(name, b.lib)))
        for name, b in built.items()
    }
    for name, lib in libraries.items():
        if not lib["instances"]:
            raise AssertionError(f"{name}: no ptxas report in the build log")
        for inst in lib["instances"]:
            if inst.get("spill_bytes", 1) != 0:
                raise AssertionError(f"{inst['instance']} spills: {inst}")
    rec = dict(phase="build", seconds=time.perf_counter() - t0, libraries=libraries,
               host_libraries={name: dict(library=str(h.path.relative_to(ROOT)),
                                          gxx_seconds=h.seconds) for name, h in hosts.items()})
    emit(rec)
    return rec


def bucket_shapes() -> tuple[list[np.ndarray], list[int]]:
    """The atom counts and caps of phase 5's buckets (same seed, same plan)."""
    sampler = MatterGenSampler(
        batch_size=BATCH, num_batches=1, size_buckets=BUCKETS, max_atoms=MAX_ATOMS,
        seed=SEED,
    )
    na = sampler._draw_num_atoms(BATCH)
    cuts, caps = sampler.bucket_plan(na)
    return [na[idx] for idx in cuts], caps


def phase_kernel(H: int = 256, nf: int = 10) -> dict:
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(1)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    # odd shapes: narrow widths, few frequencies, single atoms, a 64-atom cap
    for B, A, Hh, nff in [(5, 4, 32, 3), (7, 8, 64, 10), (3, 1, 128, 10), (2, 64, 32, 10), (9, 20, 256, 10)]:
        for dtype in errs:
            args, mask = edge_inputs(B, A, Hh, nff, dtype, gen)
            errs[dtype] = max(errs[dtype], check_kernel(args, mask, nff))
    counts, caps = bucket_shapes()
    buckets = []
    for na, cap in zip(counts, caps):
        num_atoms = torch.as_tensor(na, device=DEV)
        row = dict(cap=cap, crystals=len(na))
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            args, mask = edge_inputs(len(na), cap, H, nf, dtype, gen, num_atoms)
            errs[dtype] = max(errs[dtype], check_kernel(args, mask, nf))
            row[f"{tag}_ms"] = time_ms(lambda: fused_edge_chain(*args, num_freqs=nf), 50)
            row[f"{tag}_eager_ms"] = eager_ms(
                lambda: fused_edge_chain(*args, num_freqs=nf), 50
            )
            row[f"{tag}_plain_ms"] = time_ms(
                lambda: fused_edge_chain_plain(*args, num_freqs=nf), 10
            )
            row[f"{tag}_library_ms"] = time_ms(lambda: library_chain(args, nf), 10)
            row[f"{tag}_bound_ms"], row[f"{tag}_bound_by"] = bound(args, num_atoms, nf)
        buckets.append(row)
    rec = dict(
        phase="kernel", route={str(k): v for k, v in PEAK_ROUTE.items()},
        max_abs_err_f32=errs[torch.float32],
        max_abs_err_bf16=errs[torch.bfloat16], tol_f32=TOL[torch.float32],
        tol_bf16=TOL[torch.bfloat16], buckets=buckets,
        seconds=time.perf_counter() - t0,
    )
    emit(rec)
    return rec


LIBRARY = "chain of PyTorch ops, cuBLAS products"
# the harnesses' kernels: the wrapper that counts its launches, its source
# and the Pallas kernel it replaces
HARNESS_KERNELS = {
    "fused_edge_variant": (fused_edge_ab.edge_variant, "matinvent_tpu_torch/csrc/fused_edge.cu",
                           "experiments/fused_edge_ab_r5.py:47"),
    "flat_edge_mlp": (fused_edge_flat.flat_edge_mlp, "matinvent_tpu_torch/csrc/edge_flat.cu",
                      "experiments/fused_edge_flat_r5.py:41"),
    "fused_edge_demb": (fused_edge_flat.demb_edge, "matinvent_tpu_torch/csrc/fused_edge.cu",
                        "experiments/fused_edge_flat_r5.py:83"),
}


# (library, instance-name prefix) of each harness kernel's instances
HARNESS_INSTANCES = {
    "fused_edge_variant": ("fused_edge", "fused_edge "),
    "flat_edge_mlp": ("edge_flat", "edge_flat"),
    "fused_edge_demb": ("fused_edge", "fused_edge demb"),
}


def phase_edge_ablation() -> dict:
    """The fused-edge harnesses' kernels against their plain versions at the
    harnesses' full width (203 crystals at cap 20, 81,200 rows) and at an
    odd shape, then both harnesses' entry points at full width."""
    t0 = time.perf_counter()
    errs = {name: 0.0 for name in HARNESS_KERNELS}
    for seed, (crystals, atoms) in enumerate(EDGE_SHAPES, start=3):
        args, na = fused_edge_ab.make_inputs(np.random.default_rng(seed), crystals, atoms, DEV)
        mask = torch.as_tensor(np.arange(atoms)[None, :] < na[:, None], device=DEV)
        for mode in fused_edge_ab.ABLATIONS:
            out = fused_edge_ab.edge_variant(mode, *args)
            torch.cuda.synchronize()
            ref = fused_edge_ab.edge_variant_plain(mode, *args)
            err = check_close(out, ref, f"{mode} {crystals}x{atoms}", mask)
            errs["fused_edge_variant"] = max(errs["fused_edge_variant"], err)
        flat, demb, na = fused_edge_flat.make_inputs(
            np.random.default_rng(seed), crystals, atoms, DEV
        )
        mask = torch.as_tensor(np.arange(atoms)[None, :] < na[:, None], device=DEV)
        out = fused_edge_flat.flat_edge_mlp(*flat)
        torch.cuda.synchronize()
        err = check_close(out, fused_edge_flat.flat_edge_mlp_plain(*flat), f"flat R={len(out)}")
        errs["flat_edge_mlp"] = max(errs["flat_edge_mlp"], err)
        out = fused_edge_flat.demb_edge(*demb)
        torch.cuda.synchronize()
        err = check_close(out, fused_edge_flat.demb_edge_plain(*demb),
                          f"demb {crystals}x{atoms}", mask)
        errs["fused_edge_demb"] = max(errs["fused_edge_demb"], err)

    # the path: both harnesses as a user runs them, counting launches
    for fn, _, _ in HARNESS_KERNELS.values():
        fn.launches = 0
    fused_edge_chain.launches = 0
    ab = fused_edge_ab.main()
    flat = fused_edge_flat.main()
    if fused_edge_chain.launches:
        raise AssertionError("the harnesses launched fused_edge_chain's wrapper")

    def timing(part, chain_ms):
        return dict(ms=part["ms"], eager_ms=part["eager_ms"], plain_ms=part["plain_ms"],
                    library_ms=chain_ms)

    full = ab["modes"]["full"]  # the sampler's instance at the harness shape
    kernels = {
        "fused_edge_variant": dict(
            timing(full, ab["torch_chain_ms"]), bound_ms=ab["bound_ms"],
            bound_by=ab["bound_by"], modes_ms={m: r["ms"] for m, r in ab["modes"].items()},
            modes_eager_ms={m: r["eager_ms"] for m, r in ab["modes"].items()},
            modes_plain_ms={m: r["plain_ms"] for m, r in ab["modes"].items()},
        ),
        **{
            name: dict(timing(flat[part], flat[part]["torch_chain_ms"]),
                       bound_ms=flat[part]["bound_ms"], bound_by=flat[part]["bound_by"])
            for name, part in (("flat_edge_mlp", "flat"), ("fused_edge_demb", "demb"))
        },
    }
    for name, (fn, _, _) in HARNESS_KERNELS.items():
        if fn.launches == 0:
            raise AssertionError(f"{name} was not launched by the harnesses")
        kernels[name].update(launches=fn.launches, max_abs_err=errs[name])
    times = [t for k in kernels.values() for t in (k["ms"], k["plain_ms"], k["library_ms"])]
    times += [t for m in ab["modes"].values() for t in (m["ms"], m["plain_ms"])]
    if not all(math.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"a harness time is not a positive number: {times}")
    rec = dict(phase="edge_ablation", tol_bf16=TOL[torch.bfloat16], kernels=kernels,
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def phase_score_net(model, dtype) -> dict:
    """Full-width net, kernel edge path against plain edge path, in
    ``dtype``. f32: within 2e-4. bf16: on the real atoms, within twice the
    plain path's own bf16-against-f32 spread on the same batch, the rule
    ``tests/test_torch_port_faults.py`` holds the bf16 net to against JAX
    (two bf16 evaluations that each stay within that spread of the f32
    result are at most twice it apart)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(2)
    B, A = 16, MAX_ATOMS
    na = torch.randint(1, A + 1, (B,), generator=gen, device=DEV)
    mask = torch.arange(A, device=DEV)[None, :] < na[:, None]
    tables = model._step_tables()
    i = model.config.timesteps // 2
    noised = MGNoised(
        tables["t"][i].expand(B),
        tables["time_emb"][i][None].expand(B, -1),
        torch.randint(0, model.d3pm.vocab, (B, A), generator=gen, device=DEV),
        torch.rand((B, A, 3), generator=gen, device=DEV),
        torch.eye(3, device=DEV)[None] * 4.0
        + 0.3 * torch.randn((B, 3, 3), generator=gen, device=DEV),
    )
    with torch.no_grad():
        fused = model.apply_net(noised, na, mask, fused_edge=True, dtype=dtype)
        plain = model.apply_net(noised, na, mask, fused_edge=False, dtype=dtype)
        f32 = model.apply_net(noised, na, mask, fused_edge=False)
    torch.cuda.synchronize()
    for k, v in fused.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"score net output {k} is not finite")

    def real(x):  # the real atoms' rows of a per-atom output
        return x[mask] if x.shape[:2] == mask.shape else x

    errs = {k: (real(fused[k]) - real(plain[k])).abs().max().item() for k in fused}
    if dtype == torch.float32:
        tols = {k: 2e-4 for k in fused}
    else:
        tols = {k: 2.0 * (real(plain[k]) - real(f32[k])).abs().max().item() for k in fused}
        if min(tols.values()) <= 0:
            raise AssertionError(f"the bf16 net did not round: spread {tols}")
    if any(errs[k] > tols[k] for k in errs):
        raise AssertionError(f"fused vs plain score net ({dtype}): {errs} > {tols}")
    rec = dict(phase="score_net", dtype=str(dtype).split(".")[-1], batch=B, max_atoms=A,
               max_abs_err=errs, tol=tols, seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def sample_once(model, fused_edge: bool):
    sampler = MatterGenSampler(
        batch_size=BATCH, num_batches=1, size_buckets=BUCKETS, max_atoms=MAX_ATOMS,
        seed=SEED, fused_edge=fused_edge,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = sampler.launch(model)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for name in ("frac_coords", "lattice"):
        if not torch.isfinite(getattr(batch, name)).all():
            raise AssertionError(f"sampled {name} are not finite")
    if tuple(batch.frac_coords.shape) != (BATCH, MAX_ATOMS, 3):
        raise AssertionError(f"unexpected batch shape {tuple(batch.frac_coords.shape)}")
    return seconds, int(structure_validity(batch).sum().item())


def phase_sampling(model) -> dict:
    """256 crystals at T=1000 in the model's ``sample_dtype`` through the
    kernel (every launch counted) and through the plain edge path; the
    valid shares agree within 4 sigma."""
    c = model.config
    counts, caps = bucket_shapes()
    if len(caps) != BUCKETS:
        raise AssertionError(f"expected {BUCKETS} buckets, got caps {caps}")
    expected = c.num_layers * (1 + c.n_corrector) * c.timesteps * len(caps)
    fused_edge_chain.launches = 0
    seconds, valid = sample_once(model, fused_edge=True)
    launches = fused_edge_chain.launches
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    plain_seconds, plain_valid = sample_once(model, fused_edge=False)
    p1, p2 = valid / BATCH, plain_valid / BATCH
    pooled = (valid + plain_valid) / (2 * BATCH)
    sigma = math.sqrt(pooled * (1 - pooled) * 2 / BATCH)
    if abs(p1 - p2) > 4 * sigma:
        raise AssertionError(f"valid share kernel {p1} vs plain {p2}: beyond 4 sigma {sigma}")
    rec = dict(
        phase="sampling", batch=BATCH, timesteps=c.timesteps, caps=caps,
        crystals=[len(x) for x in counts], dtype=c.sample_dtype,
        kernel_launches=launches, seconds=seconds, structures_per_s=BATCH / seconds,
        valid_share=p1, plain_seconds=plain_seconds, plain_valid_share=p2,
        four_sigma=4 * sigma,
    )
    emit(rec)
    return rec


def chunk_grads(agent, prior, batch, rewards, draws, dev):
    """(loss, {name: gradient}) of one chunk on ``dev``."""
    accum = len(draws.cell)
    t_idx = FT_CHUNK * accum + torch.arange(accum, device=dev)
    agent.zero_grad(set_to_none=True)
    loss, _ = agent.rl_chunk_loss(
        prior, batch.to(dev), rewards.to(dev), t_idx, FT_SIGMA,
        draws=NoiseDraws(*(d.to(dev) for d in draws)),
    )
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in agent.named_parameters()}
    agent.zero_grad(set_to_none=True)
    return loss.item(), grads


def phase_finetune() -> dict:
    """One chunk of the fine-tune at full width on the card against the same
    code on the CPU in f32 (only the summation order differs: the loss and
    every gradient within 1e-4 of their scale), then one FinetuneStep epoch
    on the card: every chunk finite, the prior unchanged bit for bit, the
    agent moved. Times the epoch's chunks (forward, backward, Adam) with
    CUDA events."""
    t0 = time.perf_counter()
    agent = load_model(START, device=DEV)
    prior = load_model(START, device=DEV).requires_grad_(False)
    batch, rewards, draws = chunk_inputs(agent.d3pm.vocab)
    accum = len(draws.cell)
    loss, grads = chunk_grads(agent, prior, batch, rewards, draws, DEV)
    cpu_agent = load_model(START, device="cpu")
    cpu_prior = load_model(START, device="cpu").requires_grad_(False)
    cpu_t0 = time.perf_counter()
    cpu_loss, cpu_grads = chunk_grads(cpu_agent, cpu_prior, batch, rewards, draws, "cpu")
    cpu_seconds = time.perf_counter() - cpu_t0
    del cpu_agent, cpu_prior
    if not math.isfinite(loss) or abs(loss - cpu_loss) > 1e-4 * max(1.0, abs(cpu_loss)):
        raise AssertionError(f"chunk loss card {loss} vs cpu {cpu_loss}")
    grad_err = 0.0
    for k, g in cpu_grads.items():
        err = (grads[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-12)
        if not err <= 1e-4:
            raise AssertionError(f"gradient {k}: card vs cpu {err} of its scale > 1e-4")
        grad_err = max(grad_err, err)

    step = FinetuneStep(lr=FT_LR, timesteps=agent.config.timesteps, accum_steps=accum,
                        sigma_kl=FT_SIGMA, epochs=1)
    prior_before = {k: v.clone() for k, v in prior.state_dict().items()}
    agent_before = {k: v.clone() for k, v in agent.state_dict().items()}
    opt = step.optimizer(agent)
    gen = torch.Generator(device=DEV).manual_seed(6)
    dev_batch, dev_rewards = batch.to(DEV), rewards.to(DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    metrics = step.epoch(agent, opt, prior, dev_batch, dev_rewards, generator=gen)
    end.record()
    torch.cuda.synchronize()
    ms_per_chunk = start.elapsed_time(end) / step.n_chunks
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"a fine-tune chunk's loss is not finite: {metrics}")
    if any(not torch.equal(v, prior_before[k]) for k, v in prior.state_dict().items()):
        raise AssertionError("the prior changed during the fine-tune")
    if all(torch.equal(v, agent_before[k]) for k, v in agent.state_dict().items()):
        raise AssertionError("the fine-tune did not move the agent")

    cfg, V = agent.config, agent.d3pm.vocab
    na = batch.num_atoms.numpy()
    # agent forward + backward (twice the forward) + prior forward
    flops = 4 * accum * net_flops(na, cfg, V)
    padded = 4 * accum * net_flops(np.full_like(na, MAX_ATOMS), cfg, V)
    params = sum(p.numel() for p in agent.parameters())
    # both nets' weights and the inputs read once, the gradients written once
    moved = 4 * 3 * params + sum(nbytes(d) for d in draws) + nbytes(
        batch.frac_coords, batch.lattice, batch.atom_types)
    bound = 1e3 * max(flops / FP32_FLOPS, moved / 3.35e12)
    rec = dict(
        phase="finetune", crystals=len(na), accum_steps=accum, chunk=FT_CHUNK,
        num_atoms=na.tolist(), loss=loss, cpu_loss=cpu_loss, cpu_seconds=cpu_seconds,
        grad_max_rel_err=grad_err, tol=1e-4, epoch_metrics=metrics, chunks=step.n_chunks,
        ms_per_chunk=ms_per_chunk, bound_ms=bound, bound_by="operations",
        bound_rate="float32 outside the tensor cores, 67 TFLOP/s",
        chunk_tflop=flops / 1e12, padded_chunk_tflop=padded / 1e12,
        padded_bound_ms=1e3 * padded / FP32_FLOPS, peak_memory_bytes=peak,
        seconds=time.perf_counter() - t0,
    )
    emit(rec)
    return rec


def measure_validity(strucs) -> dict:
    """The failure shares of ``experiments/validity_fix_r5.py:32``: SMACT
    charge balance, structural sanity and cell size, and all three passed."""
    c = {"smact_fail": 0, "structural_fail": 0, "cell_fail": 0, "all_ok": 0}
    for st in strucs:
        ok_s, ok_g, ok_c = smact_valid(st), structure_validity(st), cell_size_ok(st)
        c["smact_fail"] += not ok_s
        c["structural_fail"] += not ok_g
        c["cell_fail"] += not ok_c
        c["all_ok"] += ok_s and ok_g and ok_c
    return {k: v / max(len(strucs), 1) for k, v in c.items()}


def phase_validity(model) -> dict:
    """512 crystals of the start checkpoint through the kernel (corpus_r5
    histogram, 4 buckets, seed 1); each share within 4 sigma of the
    difference of two binomial shares of the JAX package's record."""
    t0 = time.perf_counter()
    kw = dict(batch_size=VALIDITY_BATCH, num_batches=1, max_atoms=MAX_ATOMS,
              num_atoms_distribution="corpus_r5", num_atoms_distribution_file=str(HIST),
              size_buckets=BUCKETS, seed=VALIDITY_SEED)
    plan = MatterGenSampler(**kw)
    cuts, caps = plan.bucket_plan(plan._draw_num_atoms(VALIDITY_BATCH))
    c = model.config
    expected = c.num_layers * (1 + c.n_corrector) * c.timesteps * len(caps)
    fused_edge_chain.launches = 0
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    _, strucs = MatterGenSampler(**kw).generate(model)
    sample_seconds = time.perf_counter() - s0
    launches = fused_edge_chain.launches
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    shares = measure_validity(strucs)
    n, four_sigma = VALIDITY_RECORD["n"], {}
    for k, p in shares.items():
        ref = VALIDITY_RECORD[k]
        pooled = (p * len(strucs) + ref * n) / (len(strucs) + n)
        four_sigma[k] = 4 * math.sqrt(pooled * (1 - pooled) * (1 / len(strucs) + 1 / n))
        if abs(p - ref) > four_sigma[k] + 1e-12:
            raise AssertionError(f"{k}: {p} vs the JAX record {ref}, beyond 4 sigma {four_sigma[k]}")
    rec = dict(phase="validity", n=len(strucs), caps=caps, crystals=[len(x) for x in cuts],
               kernel_launches=launches, sample_seconds=sample_seconds, **shares,
               jax_record=VALIDITY_RECORD, four_sigma=four_sigma,
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec, strucs


def phase_opt_filter(strucs) -> dict:
    """``OptEval`` with the exact disordered matcher on phase ``validity``'s
    512 crystals against the 36,000-structure corpus (unrelaxed, so the
    JAX package's relaxed record is printed beside it, not compared); then
    the gate: on the first 64 crystals the native fit's unique and novel
    masks equal its plain version's, against 1,000 corpus structures."""
    t0 = time.perf_counter()
    ref = ReferenceDataset.from_files(str(CORPUS), str(CORPUS_ENERGIES))
    load_seconds = time.perf_counter() - t0
    t1 = time.perf_counter()
    metrics, kept = OptEval(structure_matcher="disordered", relax=False, reference=ref)(strucs)
    eval_seconds = time.perf_counter() - t1
    with open(GEN_EVAL_RECORD) as fh:
        record = json.load(fh)
    head, corpus_slice = strucs[:GATE_N], ref.structures[:GATE_REF]
    gate = {}
    for native in (True, False):
        m = DisorderedStructureMatcher(DisorderedExactStructureMatcher(use_native=native))
        t2 = time.perf_counter()
        feats = m.features(head)
        masks = (m.unique_mask(head, feats), m.novel_mask(head, corpus_slice, feats))
        gate["native" if native else "plain"] = (masks, time.perf_counter() - t2)
    for i, name in enumerate(("unique", "novel")):
        if not np.array_equal(gate["native"][0][i], gate["plain"][0][i]):
            raise AssertionError(f"{name}_mask: native fit differs from its plain version")
    if not all(0.0 <= v <= 1.0 for v in metrics.values()) or not kept:
        raise AssertionError(f"OptEval metrics out of range: {metrics}")
    rec = dict(
        phase="opt_filter", n=len(strucs), evaluated=len(kept), reference=len(ref.structures),
        **{k: metrics.get(k) for k in ("frac_validity", "frac_unique", "frac_novel")},
        reference_load_seconds=load_seconds, eval_seconds=eval_seconds,
        jax_relaxed_record={k: record[k] for k in ("frac_validity", "frac_unique", "frac_novel")},
        gate_n=GATE_N, gate_reference=GATE_REF,
        gate_unique=int(gate["native"][0][0].sum()), gate_novel=int(gate["native"][0][1].sum()),
        gate_native_seconds=gate["native"][1], gate_plain_seconds=gate["plain"][1],
        seconds=time.perf_counter() - t0,
    )
    emit(rec)
    return rec


class LogRecords(logging.Handler):
    """The messages the pipeline logs at INFO and above."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def numbers(self, pattern: str) -> list[float]:
        return [float(v) for m in self.messages for v in re.findall(pattern, m)]


def _iteration(pipe, log: LogRecords, run) -> dict:
    """Runs ``run()`` (one RL iteration) with the launch count set to 0
    just before and read just after; the iteration's values from its
    metrics row and the pipeline's log."""
    log.messages.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_edge_chain.launches = 0
    run()
    torch.cuda.synchronize()
    launches = fused_edge_chain.launches
    row = pipe.logger.rows[-1]
    losses = log.numbers(r"loss\w*: (\S+?)(?:,|$)")
    it = dict(
        step=int(row["step"]), kernel_launches=launches,
        valid=int(log.numbers(r"Number of valid samples: (\d+)")[0]),
        reward_mean=row.get("reward mean"),
        finetune_batch=int(log.numbers(r"Fine-tune batch: (\d+)")[0]),
        finetune_losses=losses, peak_memory_bytes=torch.cuda.max_memory_allocated(),
        **{k: row.get(k) for k in ("time_sample_s", "time_score_s", "time_finetune_s")},
    )
    if len(losses) != 3 * pipe.finetuner.epochs or not all(map(math.isfinite, losses)):
        raise AssertionError(f"iteration {it['step']}: fine-tune losses {losses}")
    return it


def _equal_tables(a: list, b: list) -> bool:
    """Memory or replay rows equal field by field (structures and the
    per-crystal dicts by their arrays)."""
    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if hasattr(x, "frac_coords"):
            return all(np.array_equal(getattr(x, f), getattr(y, f))
                       for f in ("lattice", "species", "frac_coords"))
        if isinstance(x, np.ndarray):
            return np.array_equal(x, y)
        return x == y

    return len(a) == len(b) and all(same(r, q) for r, q in zip(a, b))


def phase_rl(start_sd: dict) -> dict:
    """The rl_hhi_rich5 recipe as the entry point builds it, on the card,
    in a temporary directory: iteration 0 by ``run_rl`` (which saves the run
    state), then a fresh ``MatInvent`` resumed from that state runs
    iteration 1. The resumed agent equals the saved one bit for bit before
    its first step, the step continues at 1, the memory and replay tables
    equal the saved ones; each iteration launches 12,000 edge kernels, every
    fine-tune loss is finite, the prior is unchanged, iteration 1 samples
    from the updated agent, ``metrics.csv`` has the JAX run's columns, and
    ``models/final`` (``params.msgpack`` included) equals the agent."""
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_rl_")
    iters: list[dict] = []
    root = logging.getLogger()
    level, log = root.level, LogRecords()
    root.setLevel(logging.INFO)
    root.addHandler(log)
    try:
        pipe = mat_invent.build(mat_invent.resolve("rl_hhi_rich5", 1), out)
        c = pipe.agent.config
        expected = c.num_layers * (1 + c.n_corrector) * c.timesteps
        at_start = all(torch.equal(v.cpu(), start_sd[k]) for k, v in pipe.agent.state_dict().items())
        iters.append(dict(_iteration(pipe, log, pipe.run_rl), agent_is_start_checkpoint=at_start))
        saved = {k: v.cpu().clone() for k, v in pipe.agent.state_dict().items()}
        if not pipe.state_save_freq == 1 or not (Path(out) / "state/run_state.json").is_file():
            raise AssertionError("iteration 0 saved no run state")
        t1 = time.perf_counter()
        state = load_run_state(str(Path(out) / "state"))
        load_seconds = time.perf_counter() - t1
        t1 = time.perf_counter()
        resumed = mat_invent.build(
            mat_invent.resolve("rl_hhi_rich5", 2, ["pipeline.resume=true"]), out)
        build_seconds = time.perf_counter() - t1
        if state is None or resumed._start_step != 1 or state[1]["step"] != 0:
            raise AssertionError(f"the resumed run starts at step {resumed._start_step}, not 1")
        if any(not torch.equal(v.cpu(), saved[k]) for k, v in resumed.agent.state_dict().items()):
            raise AssertionError("the resumed agent differs from the saved one")
        if not (_equal_tables(resumed.ltm.memory, pipe.ltm.memory)
                and _equal_tables(resumed.replay.buffer, pipe.replay.buffer)):
            raise AssertionError("the resumed memory or replay tables differ from the saved ones")
        del pipe
        at_start = all(torch.equal(v.cpu(), start_sd[k])
                       for k, v in resumed.agent.state_dict().items())
        iters.append(dict(_iteration(resumed, log, resumed.run_rl),
                          agent_is_start_checkpoint=at_start))
        for it in iters:
            if it["kernel_launches"] != expected:
                raise AssertionError(f"iteration {it['step']}: {it['kernel_launches']} "
                                     f"launches, not {expected}")
        if [it["step"] for it in iters] != [0, 1]:
            raise AssertionError(f"steps {[it['step'] for it in iters]}, not [0, 1]")
        if [it["agent_is_start_checkpoint"] for it in iters] != [True, False]:
            raise AssertionError("the second iteration did not sample from the updated agent")
        if any(not torch.equal(v.cpu(), start_sd[k])
               for k, v in resumed.prior.state_dict().items()):
            raise AssertionError("the prior changed")
        with open(Path(out) / "metrics.csv") as fh, open(RL_METRICS) as ref:
            header, ref_header = fh.readline().strip(), ref.readline().strip()
            rows = len(fh.readlines())
        if header != ref_header or rows != 2:
            raise AssertionError(f"metrics.csv columns {header} != {ref_header} or {rows} rows")
        for name in ("long_term_memory.csv", "step_0000_eval.extxyz", "step_0001_eval.extxyz"):
            if not (Path(out) / "samples" / name).is_file():
                raise AssertionError(f"{name} was not written")
        final_dir = Path(out) / "models/final"
        if not (final_dir / "params.msgpack").is_file():
            raise AssertionError("models/final/params.msgpack was not written")
        final = load_model(final_dir, device=DEV)
        if any(not torch.equal(v, resumed.agent.state_dict()[k])
               for k, v in final.state_dict().items()):
            raise AssertionError("the final checkpoint differs from the agent")
    finally:
        root.removeHandler(log)
        root.setLevel(level)
        shutil.rmtree(out, ignore_errors=True)
    rec = dict(phase="rl", recipe="rl_hhi_rich5", iterations=iters, resumed_at_step=1,
               state_load_seconds=load_seconds, resumed_build_seconds=build_seconds,
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def phase_rl_async() -> dict:
    """Two rl_hhi_rich5 iterations with ``async_sampling``: both launches
    run in the sampling thread, the second submitted during iteration 0 (so
    iteration 1's batch is the pending launch, sampled with the
    pre-fine-tune-0 weights); 12,000 edge kernels each."""
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_rl_async_")
    root = logging.getLogger()
    level, log = root.level, LogRecords()
    root.setLevel(logging.INFO)
    root.addHandler(log)
    try:
        pipe = mat_invent.build(
            mat_invent.resolve("rl_hhi_rich5", 2, ["pipeline.async_sampling=true"]), out)
        c = pipe.agent.config
        expected = c.num_layers * (1 + c.n_corrector) * c.timesteps
        launches_seen: list[tuple[int, str]] = []
        launch = pipe._launch_sampling

        def recorded():
            launches_seen.append((pipe.step, threading.current_thread().name))
            return launch()

        pipe._launch_sampling = recorded
        iters = []
        for step in range(pipe.rl_epoch):
            pipe.step = step
            iters.append(_iteration(pipe, log, pipe.rl_step))
        pipe._sampling_pool.shutdown(wait=True)
        total = sum(it["kernel_launches"] for it in iters)
        if total != 2 * expected:
            raise AssertionError(f"async iterations launched {total}, not {2 * expected}")
        if len(launches_seen) != 2 or any(s != 0 or not t.startswith("sampling")
                                          for s, t in launches_seen):
            raise AssertionError(f"launches (step, thread): {launches_seen}")
        if pipe._pending is not None:
            raise AssertionError("a launch is pending after the last iteration")
    finally:
        root.removeHandler(log)
        root.setLevel(level)
        shutil.rmtree(out, ignore_errors=True)
    rec = dict(phase="rl_async", recipe="rl_hhi_rich5", iterations=iters,
               launches=[dict(step=s, thread=t) for s, t in launches_seen],
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def record_structures(record: dict) -> list[Structure]:
    """The structures of the JAX record: the corpus head, then the
    degenerate ones it stores."""
    head = read_extxyz(str(ROOT / record["corpus"]), limit=record["n_corpus"])
    return head + [Structure(np.asarray(r["lattice"], float), np.asarray(r["species"]),
                             np.asarray(r["frac_coords"], float)) for r in record["degenerate"]]


def check_values(ours, ref, atol, rtol, what: str) -> float:
    """Max |ours - ref| on the finite entries; raises past ``atol + rtol
    |ref|`` or where NaN or inf differ."""
    a, b = np.asarray(ours, float), np.asarray(ref, float)
    fin = np.isfinite(b)
    if not (np.array_equal(np.isfinite(a), fin)
            and np.array_equal(a[~fin], b[~fin], equal_nan=True)):
        raise AssertionError(f"{what}: NaN or inf entries differ from JAX")
    err = np.abs(a[fin] - b[fin])
    if (err > atol + rtol * np.abs(b[fin])).any():
        raise AssertionError(f"{what}: card vs JAX {err.max()} > {atol} + {rtol} |ref|")
    return float(err.max(initial=0.0))


def median_ms(fn, repeats: int) -> float:
    """Median wall milliseconds of ``fn()``, synchronized, after one warm-up."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def phase_predictor() -> dict:
    """The six in-repo predictors loaded on the card (each ``loaded``),
    their raw outputs within 1e-4 of ``y_std`` of the JAX record, the ten
    tasks within 1e-4 relative of it (plus 1e-4 of the task's largest
    value: a derived task multiplies two predictions), SynScore within
    1e-6; each model's time per call at batch 64 and 512 (the call as the
    reward makes it, host batching included, and its device forward
    alone); then 20 trainer steps at full width, the first step's loss
    against the CPU's (1e-4 relative), every loss finite and the last five
    below the first five."""
    t0 = time.perf_counter()
    with open(REWARD_RECORD) as fh:
        record = json.load(fh)
    strucs = record_structures(record)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_predictor_")
    try:
        calc = PropertyPredictor(tmp, device=DEV)
        tasks_of = {m: t for t, m in TASK_MODEL_DICT.items() if m}
        load_seconds, raw_err, models = {}, {}, {}
        for name, task in tasks_of.items():
            t1 = time.perf_counter()
            gnn = calc._model(task)
            torch.cuda.synchronize()
            load_seconds[name] = time.perf_counter() - t1
            if not gnn.loaded or gnn.device.type != torch.device(DEV).type:
                raise AssertionError(f"{name}: not loaded on the card")
            models[name] = gnn
            raw_err[name] = check_values(gnn.predict(strucs), record["raw"][name],
                                         PRED_TOL * gnn.y_std, 0.0, name) / gnn.y_std
        task_err = {}
        for task in TASK_MODEL_DICT:
            calc.task = task
            ref = np.asarray(record["tasks"][task], float)
            scale = np.abs(ref[np.isfinite(ref)]).max()
            task_err[task] = check_values(calc.calc((strucs, None), task), ref,
                                          PRED_TOL * scale, PRED_TOL, task)
        ok = [bool(((s.species >= 0) & (s.species <= 100)).all()) for s in strucs]
        syn = SynScore(tmp, device=DEV)
        if not syn.trained:
            raise AssertionError("SynScore did not load the in-repo ensemble")
        scores = np.full(len(strucs), np.nan)
        scores[ok] = syn.calc(([s for s, m in zip(strucs, ok) if m], None), "syn")
        syn_err = check_values(scores, record["syn_score"], SYN_TOL, 0.0, "syn_score")

        corpus = read_extxyz(str(CORPUS), limit=max(PRED_BATCHES) + TRAIN_BATCH * TRAIN_STEPS)
        timing = {}
        for n in PRED_BATCHES:
            head = corpus[:n]
            gnn = models["mp_total_mag_per_atom"]
            batch = gnn.batch(head)

            def forward():
                with torch.no_grad():
                    gnn.forward(batch)

            timing[n] = dict(
                call_ms={name: median_ms(lambda m=m: m.predict(head), PRED_REPEATS)
                         for name, m in models.items()},
                forward_ms=median_ms(forward, PRED_REPEATS),
                syn_score_ms=median_ms(lambda: syn.calc((head, None), "t"), PRED_REPEATS),
            )

        # the trainer, card against CPU on the first step, then 20 steps
        train = corpus[max(PRED_BATCHES):]
        labels = label_structures(train, TRAIN_MODEL)
        y = (labels - np.nanmean(labels)) / np.nanstd(labels)
        first = {}
        for dev in ("cpu", DEV):
            gnn = PropertyGNN(TRAIN_MODEL, model_dir="", seed=0, device=dev)
            trainer = PredictorTrainer(gnn, lr=1e-3)
            batches = labeled_batches(train, y, TRAIN_BATCH, gnn.max_atoms,
                                      np.random.default_rng(0))
            opt = trainer.optimizer()
            b, yy = next(batches)
            first[dev] = float(trainer.step(opt, b, yy))
        losses = [first[DEV]]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(TRAIN_STEPS - 1):
            b, yy = next(batches)
            losses.append(float(trainer.step(opt, b, yy)))
        step_ms = 1e3 * (time.perf_counter() - t1) / (TRAIN_STEPS - 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if abs(first[DEV] - first["cpu"]) > 1e-4 * abs(first["cpu"]):
        raise AssertionError(f"first trainer loss card {first[DEV]} vs cpu {first['cpu']}")
    if not all(map(math.isfinite, losses)) or not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"trainer losses {losses}")
    rec = dict(
        phase="predictor", structures=len(strucs), corpus=record["n_corpus"],
        loaded={name: m.loaded for name, m in models.items()}, load_seconds=load_seconds,
        max_err_over_y_std=raw_err, task_max_abs_err=task_err, syn_score_max_abs_err=syn_err,
        tol=dict(raw=PRED_TOL, syn_score=SYN_TOL), timing=timing,
        trainer=dict(model=TRAIN_MODEL, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                     first_loss=first[DEV], cpu_first_loss=first["cpu"], losses=losses,
                     ms_per_step=step_ms),
        seconds=time.perf_counter() - t0,
    )
    emit(rec)
    return rec


def phase_rl_mag() -> dict:
    """Two rl_mag_rich_dense iterations as the entry point builds them, on
    the card, in a temporary directory: 12,000 edge kernels each, a finite
    magnetic-density mean scored on the card, ``time_score_s`` per
    iteration, and the archived JAX run's ``metrics.csv`` columns."""
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_rl_mag_")
    root = logging.getLogger()
    level, log = root.level, LogRecords()
    root.setLevel(logging.INFO)
    root.addHandler(log)
    try:
        pipe = mat_invent.build(mat_invent.resolve("rl_mag_rich_dense", 2), out)
        calc = pipe.reward.prop_cfg[0]["calculator"]
        if not isinstance(calc, PropertyPredictor) or calc.device.type != torch.device(DEV).type:
            raise AssertionError(f"the reward's calculator is {calc!r}, not a predictor on the card")
        c = pipe.agent.config
        expected = c.num_layers * (1 + c.n_corrector) * c.timesteps
        iters = []
        for step in range(pipe.rl_epoch):
            pipe.step = step
            it = _iteration(pipe, log, pipe.rl_step)
            it["magnetic_density_mean"] = pipe.logger.rows[-1].get("magnetic_density mean")
            iters.append(it)
        for it in iters:
            if it["kernel_launches"] != expected:
                raise AssertionError(f"iteration {it['step']}: {it['kernel_launches']} "
                                     f"launches, not {expected}")
            if not math.isfinite(float(it["magnetic_density_mean"])):
                raise AssertionError(f"iteration {it['step']}: magnetic density mean "
                                     f"{it['magnetic_density_mean']}")
            if it["time_score_s"] is None:
                raise AssertionError(f"iteration {it['step']}: no time_score_s")
        if not calc._models["mp_total_mag_per_atom"].loaded:
            raise AssertionError("the magnetic-moment predictor did not load")
        with open(Path(out) / "metrics.csv") as fh, open(RL_MAG_METRICS) as ref:
            header, ref_header = fh.readline().strip(), ref.readline().strip()
        if header != ref_header:
            raise AssertionError(f"metrics.csv columns {header} != {ref_header}")
    finally:
        root.removeHandler(log)
        root.setLevel(level)
        shutil.rmtree(out, ignore_errors=True)
    rec = dict(phase="rl_mag", recipe="rl_mag_rich_dense", iterations=iters,
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def _run_logged(fn):
    """``fn(log)`` with the pipeline's INFO log captured."""
    root = logging.getLogger()
    level, log = root.level, LogRecords()
    root.setLevel(logging.INFO)
    root.addHandler(log)
    try:
        return fn(log)
    finally:
        root.removeHandler(log)
        root.setLevel(level)


def phase_diffcsp() -> dict:
    """``experiments/results/pretrained`` through ``DiffCSPSuite``: the f32
    score net on the card against the CPU on the same inputs; 128 crystals
    at T=1000 (their seconds, validity shares and peak memory); one
    iteration of the ``diffcsp_hhi`` recipe as the entry point builds it.
    No edge kernel runs."""
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    suite = DiffCSPSuite(model_path=str(DIFFCSP_CKPT),
                         config_overrides={"sample_clip": DIFFCSP_CLIP}, device=DEV)
    model = suite.load_model()
    load_seconds = time.perf_counter() - t1
    cpu_model = DiffCSPSuite(model_path=str(DIFFCSP_CKPT), device="cpu").load_model()
    c = model.config
    rng = np.random.default_rng(0)
    B, A, K = 64, DIFFCSP_MAX_ATOMS, c.max_atomic_num
    na = torch.from_numpy(rng.integers(1, A + 1, B).astype(np.int64))
    mask = torch.arange(A)[None, :] < na[:, None]
    times = torch.from_numpy(rng.integers(1, c.timesteps + 1, B))
    inputs = NoisedInput(
        sinusoidal_time_embedding(times, c.time_dim),
        torch.from_numpy(rng.normal(size=(B, A, K)).astype(np.float32)),
        torch.from_numpy(rng.uniform(size=(B, A, 3)).astype(np.float32)),
        torch.from_numpy((np.eye(3) * 5.0 + rng.normal(size=(B, 3, 3))).astype(np.float32)),
    )
    with torch.no_grad():
        ref = cpu_model.apply_net(inputs, na, mask)
        got = model.apply_net(NoisedInput(*(x.to(DEV) for x in inputs)), na.to(DEV), mask.to(DEV))
    net_err = 0.0
    for name, g, r in zip(("lattice", "coords", "types"), got, ref):
        err = (g.cpu() - r).abs()
        if r.dim() == 3 and r.shape[1] == A:
            err = err * mask[..., None]
        rel = err.max().item() / max(1.0, r.abs().max().item())
        if not rel <= NET_TOL:
            raise AssertionError(f"DiffCSP score net {name}: card vs cpu {rel} > {NET_TOL}")
        net_err = max(net_err, rel)
    del cpu_model

    sampler = DiffCSPSampler(batch_size=DIFFCSP_BATCH, num_batches=1, max_atoms=A, seed=SEED)
    fused_edge_chain.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    batch = sampler.launch(model)
    torch.cuda.synchronize()
    sample_seconds = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    if fused_edge_chain.launches != 0:
        raise AssertionError("DiffCSP sampling launched the edge kernel")
    for name in ("frac_coords", "lattice"):
        if not torch.isfinite(getattr(batch, name)).all():
            raise AssertionError(f"sampled {name} are not finite")
    if tuple(batch.frac_coords.shape) != (DIFFCSP_BATCH, A, 3):
        raise AssertionError(f"unexpected batch shape {tuple(batch.frac_coords.shape)}")
    _, strucs = batch_to_structures(batch)
    shares = measure_validity(strucs)
    del model

    def one_iteration(log):
        out = tempfile.mkdtemp(prefix="chip_smoke_diffcsp_")
        try:
            pipe = mat_invent.build(mat_invent.resolve("diffcsp_hhi", 1), out)
            if type(pipe.agent).__name__ != "DiffCSPDiffusion" or pipe.ddpo is not None:
                raise AssertionError("diffcsp_hhi did not build a reward-weighted DiffCSP run")
            prior_before = {k: v.clone() for k, v in pipe.prior.state_dict().items()}
            it = _iteration(pipe, log, pipe.run_rl)
            if it["kernel_launches"] != 0:
                raise AssertionError("the DiffCSP iteration launched the edge kernel")
            if any(not torch.equal(v, prior_before[k]) for k, v in pipe.prior.state_dict().items()):
                raise AssertionError("the prior changed")
            if not (Path(out) / "models/final/params.msgpack").is_file():
                raise AssertionError("models/final/params.msgpack was not written")
            return it
        finally:
            shutil.rmtree(out, ignore_errors=True)

    it = _run_logged(one_iteration)
    rec = dict(phase="diffcsp", checkpoint=str(DIFFCSP_CKPT.relative_to(ROOT)),
               load_seconds=load_seconds, net_max_rel_err=net_err, net_tol=NET_TOL,
               batch=DIFFCSP_BATCH, max_atoms=A, timesteps=c.timesteps,
               sample_clip=DIFFCSP_CLIP, sample_seconds=sample_seconds,
               structures_per_s=DIFFCSP_BATCH / sample_seconds, validity=shares,
               sample_peak_memory_bytes=peak, iteration=it,
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def phase_ddpo(name: str, recipe: str) -> dict:
    """Two iterations of a DDPO recipe as the entry point builds them, in a
    temporary directory. In iteration 0, before its update, the whole
    recorded trajectory is replayed at the recording weights: the mean
    importance ratio within 1e-5 of 1 and no ratio clipped. Every iteration
    writes finite ``ddpo_*`` columns and launches no edge kernel; the agent
    moves and the prior does not."""
    t0 = time.perf_counter()

    def run(log):
        out = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        try:
            pipe = mat_invent.build(mat_invent.resolve(recipe, 2), out)
            if pipe.ddpo is None or not pipe.sampler.record_trajectories:
                raise AssertionError(f"{recipe} did not build a DDPO run")
            replays = []
            ddpo_run = pipe.ddpo.run

            def run_after_replay(agent, traj, num_atoms, mask, rewards, rows=None, **replay):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                st = pipe.ddpo.replay_stats(agent, traj, num_atoms, mask, rows=rows, **replay)
                # the share of the recorded next cells held at the sample clip
                cells = traj["next_lattices" if "next_lattices" in traj else "cell"]
                clipped = (cells.abs() >= agent.config.sample_clip).float().mean().item()
                replays.append(dict(st, seconds=time.perf_counter() - t1, rows=len(rows),
                                    clipped_cell_share=clipped))
                return ddpo_run(agent, traj, num_atoms, mask, rewards, rows=rows, **replay)

            pipe.ddpo.run = run_after_replay
            prior_before = {k: v.clone() for k, v in pipe.prior.state_dict().items()}
            agent_before = {k: v.clone() for k, v in pipe.agent.state_dict().items()}
            iters = []
            for step in range(pipe.rl_epoch):
                pipe.step = step
                log.messages.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fused_edge_chain.launches = 0
                pipe.rl_step()
                torch.cuda.synchronize()
                row = pipe.logger.rows[-1]
                it = dict(
                    step=int(row["step"]), kernel_launches=fused_edge_chain.launches,
                    valid=int(log.numbers(r"Number of valid samples: (\d+)")[0]),
                    reward_mean=row.get("reward mean"),
                    ddpo_batch=int(log.numbers(r"DDPO batch: (\d+)")[0]),
                    epoch_stats=list(pipe.ddpo.epoch_stats),
                    peak_memory_bytes=torch.cuda.max_memory_allocated(),
                    **{k: row.get(k) for k in ("time_sample_s", "time_score_s", "time_finetune_s",
                                               "ddpo_ratio_mean", "ddpo_ratio_max",
                                               "ddpo_clip_frac")},
                )
                if it["kernel_launches"] != 0:
                    raise AssertionError(f"{recipe} iteration {step} launched the edge kernel")
                if not all(math.isfinite(float(it[k])) for k in
                           ("ddpo_ratio_mean", "ddpo_ratio_max", "ddpo_clip_frac")):
                    raise AssertionError(f"{recipe} iteration {step}: ddpo columns {it}")
                iters.append(it)
            first = replays[0]
            if not (abs(first["ratio_mean"] - 1.0) <= RATIO_TOL and first["clip_frac"] == 0.0):
                raise AssertionError(f"{recipe}: the replay at the recording weights gives {first}")
            if any(not torch.equal(v, prior_before[k]) for k, v in pipe.prior.state_dict().items()):
                raise AssertionError("the prior changed")
            moved = any(not torch.equal(v, agent_before[k])
                        for k, v in pipe.agent.state_dict().items())
            # standardized advantages are all 0 when every reward is equal
            if not moved and any(float(r.get("reward std") or 0) > 0 for r in pipe.logger.rows):
                raise AssertionError("DDPO did not move the agent")
            cfg = dict(lr=pipe.ddpo.lr, chunk=pipe.ddpo.chunk, epochs=pipe.ddpo.epochs,
                       batch=pipe.sampler.batch_size, max_atoms=pipe.sampler.max_atoms,
                       timesteps=pipe.agent.config.timesteps,
                       family=type(pipe.agent).__name__)
            return iters, replays, cfg
        finally:
            shutil.rmtree(out, ignore_errors=True)

    iters, replays, cfg = _run_logged(run)
    rec = dict(phase=name, recipe=recipe, **cfg, iterations=iters,
               replay_at_recording_weights=replays, ratio_tol=RATIO_TOL,
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def instances(build_rec: dict, library: str, prefix: str) -> list[dict]:
    """The build's instances of ``library`` whose name starts with
    ``prefix``: registers, spills and shared memory of each."""
    return [i for i in build_rec["libraries"][library]["instances"]
            if i["instance"].startswith(prefix)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = phase_device()
    built = phase_build()
    kern = phase_kernel()
    abl = phase_edge_ablation()
    model = load_model(CKPT, device=DEV)
    phase_score_net(model, torch.float32)
    samp = phase_sampling(model)
    del model
    model = load_model(CKPT, device=DEV, config_overrides={"sample_dtype": "bfloat16"})
    phase_score_net(model, torch.bfloat16)
    samp_bf16 = phase_sampling(model)
    del model
    phase_finetune()
    model = load_model(START, device=DEV)
    start_sd = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    valid, strucs = phase_validity(model)
    del model
    phase_opt_filter(strucs)
    rl = phase_rl(start_sd)
    rl_async = phase_rl_async()
    phase_predictor()
    rl_mag = phase_rl_mag()
    csp = phase_diffcsp()
    ddpo = [phase_ddpo("ddpo_diffcsp", "rl_hhi_ddpo"),
            phase_ddpo("ddpo_mattergen", "rl_hhi_ddpo_mattergen_t1000")]
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    b = kern["buckets"]
    common = dict(route="cuda", impl="cuda", checked=True)
    emit({"kernels": [dict(common,
        name="fused_edge_chain",
        source="matinvent_tpu_torch/csrc/fused_edge.cu",
        replaces="matinvent_tpu/ops/fused_edge.py:73",
        launches=samp["kernel_launches"],
        launches_bf16=samp_bf16["kernel_launches"],
        launches_validity=valid["kernel_launches"],
        launches_rl=[it["kernel_launches"] for it in rl["iterations"]],
        launches_rl_async=[it["kernel_launches"] for it in rl_async["iterations"]],
        launches_rl_mag=[it["kernel_launches"] for it in rl_mag["iterations"]],
        # DiffCSP and DDPO run the plain net: checked to be 0
        launches_diffcsp_ddpo=[csp["iteration"]["kernel_launches"]] + [
            it["kernel_launches"] for rec in ddpo for it in rec["iterations"]],
        max_abs_err=kern["max_abs_err_f32"],
        max_abs_err_bf16=kern["max_abs_err_bf16"],
        # one layer-eval of the batch: the sum over the bucket shapes, f32
        # (3xTF32); device time, and the same calls launched from Python
        ms=sum(r["f32_ms"] for r in b),
        eager_ms=sum(r["f32_eager_ms"] for r in b),
        plain_ms=sum(r["f32_plain_ms"] for r in b),
        bound_ms=sum(r["f32_bound_ms"] for r in b),
        bound_by=b[-1]["f32_bound_by"],
        bound_route=PEAK_ROUTE[torch.float32],
        # no single PyTorch call computes this chain: the time of the same
        # function as a chain of PyTorch ops (cuBLAS products), f32
        library_ms=sum(r["f32_library_ms"] for r in b),
        library=LIBRARY,
        bf16_ms=sum(r["bf16_ms"] for r in b),
        bf16_eager_ms=sum(r["bf16_eager_ms"] for r in b),
        bf16_plain_ms=sum(r["bf16_plain_ms"] for r in b),
        bf16_bound_ms=sum(r["bf16_bound_ms"] for r in b),
        bf16_bound_route=PEAK_ROUTE[torch.bfloat16],
        bf16_library_ms=sum(r["bf16_library_ms"] for r in b),
        instances=instances(built, "fused_edge", "fused_edge full"),
    )] + [
        # #2's times and bound are those of mode "full" (the sampler's
        # instance) at the harness's shape, bf16; every mode in modes_ms
        dict(common, name=name, source=HARNESS_KERNELS[name][1],
             replaces=HARNESS_KERNELS[name][2], library=LIBRARY,
             bound_route=PEAK_ROUTE[torch.bfloat16],
             instances=instances(built, *HARNESS_INSTANCES[name]), **k)
        for name, k in abl["kernels"].items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"], "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
