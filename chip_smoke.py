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
  beside the plain edge path on the same buckets and draws for the first
  10 steps, each bucket's state there against the kernel run's (phase
  ``sampling``);
* the edge kernel's wide route in the sampler (phase ``edge_shapes``),
  f32, T=50, random weights from a seed scaled by 0.02: an h384/L6 model
  (no tiled instance's width) sampling 32 crystals in 2 buckets, and an
  h256/L6 model at ``max_atoms`` 72 in 3 buckets whose cap-72 bucket takes
  the wide route; every bucket launches as the plan says, its first
  score-net eval against the plain net and its final crystals against a
  plain-net run on the same draws;
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
  their time per call at batch 64 and 512, 20 ``PredictorTrainer``
  steps at full width, the first against the CPU, and
  ``tools.train_predictor`` for 300 steps on the card, its checkpoint
  reloaded on the card and on the CPU;
* two RL iterations of the ``rl_mag_rich_dense`` recipe (phase
  ``rl_mag``), rewarded by the magnetic-density predictor on the card;
* the DiffCSP family (phase ``diffcsp``): the in-repo checkpoint
  ``experiments/results/pretrained`` loaded by ``DiffCSPSuite``, its f32
  score net on the card against the CPU, 128 crystals sampled at T=1000
  (``max_atoms`` 8, ``sample_clip`` 30) with their validity shares, and one
  reward-weighted iteration of the ``diffcsp_hhi`` recipe; the score net
  with ``ip=False``, ``use_dis_emb=False`` and both (random weights at
  h128/L4) on the card against the CPU;
* DDPO (phases ``ddpo_diffcsp`` and ``ddpo_mattergen``): two iterations of
  ``rl_hhi_ddpo`` and of ``rl_hhi_ddpo_mattergen_t1000``; in iteration 0
  the replay of the recorded trajectory at the recording weights must give
  a mean importance ratio of 1 within 1e-5 and no clipped ratio, and each
  PPO epoch's ratio statistics are reported. These phases run the plain
  net (DiffCSP's ``CSPNet`` has no fused edge branch, and DDPO records and
  replays on the plain net), so they launch none of the kernels: the count
  is read and must stay 0;
* the relaxer and the native phonon / elastic workflows (phase
  ``relax_phonon``): 32 ``corpus_r5`` structures, LiF and PbS relaxed on
  the card against the CPU, the Hessian of a 64-atom supercell, C_v and
  the bulk modulus against the CPU, and the whole workflows' seconds per
  structure, peak memory and NaN share on the card;
* two RL iterations of ``rl_heat_capacity_t1000`` (phase ``rl_heat``):
  128 crystals of ``pretrained_mattergen_t1000`` through the edge kernel
  (2,000 launches each on a 250-step grid), scored by the MLIP bridge's
  heat-capacity worker on the card;
* CSP mode (phase ``csp``): 64 crystals of two fixed compositions at
  T=1000 through the kernel, their types equal to the compositions;
* knn edges (phase ``knn``): the same checkpoint with ``edge_style: knn``,
  its score net on the card against the CPU, and 64 crystals sampled on
  the plain net (the kernel takes fc edges only: 0 launches);
* conditional DDPO (phase ``ddpo_cond``): two ``rl_cond_ddpo`` iterations,
  held as the other DDPO phases.
* the config-driven entry points as a user runs them: ``python -m
  matinvent_tpu_torch.main`` with ``model=mattergen`` from the start
  checkpoint, ``reward=hhi`` and ``configs/``'s defaults for one iteration
  (phase ``main``), the same with ``pipeline=baseline`` (phase
  ``baseline``: the agent bit-equal afterwards), and ``gen_eval`` at 1 x 64
  crystals with the 1024 record's arguments (phase ``gen_eval``); each
  launches the edge kernel as the sampler's plan says (one padded batch:
  12,000 launches per call);
* pretraining (phase ``pretrain``): one DiffCSP step at
  ``configs/model/diffcsp.yaml``'s width and one MatterGen step at h256/L6
  on the card against the CPU, then ``tools.pretrain`` for 50 steps on
  ``corpus_r5`` at batch 128, its checkpoint reloaded and sampled; the
  plain net trains, so no edge kernel is launched (read and held at 0);
* SynScore's trainer (phase ``syn_score_train``): one batched update of
  all 100 bags, card against CPU.
* the ALIGNN reward (phase ``alignn``) at the published widths from random
  weights written in the HF folder layout: card against CPU on 646
  structures, the host graph build apart from the device forward at chunk
  16 and 128, structures per second, peak memory, the NaN share, and one
  ``main`` iteration with ``reward=band_gap_alignn`` (the edge kernel
  against its plain version at that iteration's bucket shapes, a finite
  band gap for every structure scored);
* data parallel (phase ``dp``): the entry point in a child process that
  joins a one-rank NCCL group from ``MATINVENT_COORDINATOR``; then two
  ``gloo`` ranks on the card (``experiments/dp_check.py``) sampling their
  rows of 64 DiffCSP crystals at T=1000 and 64 MatterGen crystals on a
  250-step grid and running one MatterGen DDPO update, each gathered
  result against one process (the
  recorded trajectories' first steps against the whole batch), each
  rank's edge-kernel launches against its plan and the kernel against its
  plain version at each rank's shapes;
* the tools (phases ``convert``, ``distill``, ``reward_ceiling``): the
  MatterGen converter's round trip on ``pretrained_mattergen_t1000``, bit
  for bit; ``tools.distill_mattergen`` as a user runs it (the demo
  teacher into an h128/L4, T=100 student, 200 steps at batch 64; one step
  card against CPU first, the kernel against its plain version at the
  student sample's shapes, the launches read around each part: 800 in the
  student's sample, none in training or in the teacher-scored sample);
  ``tools.reward_ceiling``'s scoring of the first 2,048 designs for two
  predictor rewards card against CPU, and 8 heat-capacity designs through
  the MLIP bridge's worker on the card, held against JAX's record.

Kernel times are device times (CUDA graph replay, ``experiments/timing.py``).
Each phase prints one JSON line (the harnesses print their own records
too); the line before the last is the ``{"kernels": [...]}`` record and the
last line is ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that line. It needs one CUDA card;
without one it exits non-zero at once. It writes the kernel builds
(``matinvent_tpu_torch/_build/``) and, for the RL phases, temporary
directories that it removes.
"""
from __future__ import annotations

import copy
import dataclasses
import ctypes
import json
import logging
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from matinvent_tpu_torch.chem import phonon
from matinvent_tpu_torch.chem.matcher import (
    DisorderedExactStructureMatcher,
    DisorderedStructureMatcher,
)
from matinvent_tpu_torch.chem.proxy_labels import label_structures
from matinvent_tpu_torch.chem.relax import SoftSphereRelaxer
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz, save_extxyz
from matinvent_tpu_torch.chem.validity import cell_size_ok, smact_valid, structure_validity
from matinvent_tpu_torch.csrc.build import build, build_host
from matinvent_tpu_torch.experiments import dp_check, fused_edge_ab, fused_edge_flat
from matinvent_tpu_torch.experiments.edge_cycles import EDGE_SHAPES_RUNS, EDGE_SHAPES_SEED
from matinvent_tpu_torch.experiments.phonon_check import heat_against_jax, phonon_pair, rocksalt
from matinvent_tpu_torch.experiments.rl_profile import chunk_inputs, net_flops
from matinvent_tpu_torch.experiments.timing import (
    PEAK_ROUTE,
    bound_ms,
    eager_ms,
    nbytes,
    time_ms,
)
from matinvent_tpu_torch.models.cspnet import CSPNet, sinusoids_embedding
from matinvent_tpu_torch import gen_eval as entry_gen_eval
from matinvent_tpu_torch import main as entry_main
from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
    MGNoised,
    NoiseDraws,
)
from matinvent_tpu_torch.models.diffcsp import DiffCSPDiffusion, NoisedInput, sinusoidal_time_embedding
from matinvent_tpu_torch.models.diffcsp import NoiseDraws as CSPNoiseDraws
from matinvent_tpu_torch.models.mattergen.sample import (
    MatterGenSampler,
    register_num_atoms_distribution,
)
from matinvent_tpu_torch.models.sample import DiffCSPSampler, batch_to_structures
from matinvent_tpu_torch.models.suite.diffcsp import DiffCSPSuite
from matinvent_tpu_torch.models.suite.mattergen import load_config as mattergen_config
from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite, load_model
from matinvent_tpu_torch.ops.fused_edge import (
    fused_edge_chain,
    fused_edge_chain_plain,
    kernel_takes,
    tiled,
    wide_layout,
)
from matinvent_tpu_torch.parallel.pretrain import PretrainTrainer, structures_to_batches
from matinvent_tpu_torch.parallel.mesh import Mesh
from matinvent_tpu_torch.parallel.train import FinetuneStep
from matinvent_tpu_torch.parallel.train_predictor import PredictorTrainer, labeled_batches
from matinvent_tpu_torch.pipeline import mat_invent
from matinvent_tpu_torch.pipeline.baseline import Baseline
from matinvent_tpu_torch.pipeline.filters import OptEval, ReferenceDataset
from matinvent_tpu_torch.rewards.calculators import PropertyPredictor, SynScore
from matinvent_tpu_torch.rewards.calculators.alignn import ALIGNN, ALIGNNModel, ALIGNNSpec
from matinvent_tpu_torch.rewards.calculators.alignn.calc import usable as alignn_usable
from matinvent_tpu_torch.rewards.calculators.alignn.graphs import build_batch as alignn_build_batch
from matinvent_tpu_torch.rewards.calculators.alignn.model import run_batch as alignn_run_batch
from matinvent_tpu_torch.rewards.calculators.mlip import MLIPBridge
from matinvent_tpu_torch.rewards.calculators.predictor import TASK_MODEL_DICT, PropertyGNN
from matinvent_tpu_torch.tools import convert_mattergen_ckpt as convert_tool
from matinvent_tpu_torch.tools import distill_mattergen as distill_tool
from matinvent_tpu_torch.tools import pretrain as pretrain_tool
from matinvent_tpu_torch.tools import reward_ceiling as ceiling_tool
from matinvent_tpu_torch.tools import train_predictor as train_predictor_tool
from matinvent_tpu_torch.tools import train_syn_score
from matinvent_tpu_torch.utils.checkpoint import load_run_state
from matinvent_tpu_torch.utils.config import load_config, read_flat_yaml
from matinvent_tpu_torch.utils.yaml_io import read_yaml

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
# then ``tools.train_predictor`` for TOOL_STEPS steps on the same structures
TOOL_STEPS = 300
RL_MAG_METRICS = ROOT / "experiments/results/rl_mag_rich_dense/metrics.csv"
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
# the DiffCSP family: the in-repo checkpoint, sampled as the DDPO recipes
# sample it (128 crystals of at most 8 atoms, sample_clip 30); its score
# net card against CPU within 2e-4 of scale (the f32 score-net line)
DIFFCSP_CKPT = ROOT / "experiments/results/pretrained"
DIFFCSP_BATCH, DIFFCSP_MAX_ATOMS, DIFFCSP_CLIP, NET_TOL = 128, 8, 30.0, 2e-4
# DDPO: the replay at the recording weights, mean ratio within 1e-5 of 1
RATIO_TOL = 1e-5
# the heat-capacity and conditional-DDPO recipes' MatterGen checkpoint
# (h128/L4, T=1000); CSP mode's two compositions and batch; knn's batch.
# Its chains in phases rl_heat, knn, ddpo_mattergen, ddpo_cond and dp (and
# the chains of rl_async, rl_mag and the conditional checkpoint's) run on a
# MG_STEPS-step grid of their continuous-time SDEs, for the smoke's time
# limit: every check of those phases is independent of the grid's length.
# csp keeps T=1000, as does DiffCSP's discrete schedule
MG_T1000 = ROOT / "experiments/results/pretrained_mattergen_t1000"
MG_STEPS = 250
MG_STEPS_SETS = [f"model.config_overrides.timesteps={MG_STEPS}",
                 f"model.finetune_cfg.timesteps={MG_STEPS}"]
CSP_COMPOSITIONS = [{"Na": 4, "Cl": 4}, {"Ti": 2, "O": 4}]
CSP_BATCH, KNN_BATCH = 64, 64
# phase relax_phonon: corpus structures, and the supercell budget of the
# card-against-CPU comparison of C_v on structures as given
PHONON_CORPUS, PHONON_SUPERCELL = 32, 32
# the config-driven entry points: ``main``/``Baseline`` with configs/'
# defaults (base OptFilter, 64 samples); gen_eval 1 x 64 crystals (for the
# smoke's time limit)
MAIN_ARGS = ["model=mattergen", f"model.model_path={START}", "reward=hhi", "rl_epoch=1",
             "eval_size=16"]
GEN_EVAL_BATCH, GEN_EVAL_BATCHES = 64, 1
# pretraining: configs/model/diffcsp.yaml's width on corpus_r5; MatterGen's
# step at the start checkpoint's h256/L6. Card vs CPU on the same draws,
# both f32 (TF32 off): the loss and the gradient norm within the net's own
# card-vs-CPU spread (DiffCSP: NET_TOL, phase diffcsp; MatterGen: the
# fine-tune chunk's 1e-4, phase finetune); after one Adam step every weight
# within 2 lr and all but 1% within lr / 100 (a gradient at f32 noise level
# may move its weight by lr in opposite directions)
PRETRAIN_STEPS, PRETRAIN_BATCH, PRETRAIN_LR = 50, 128, 1e-3
MG_PRETRAIN_BATCH, MG_PRETRAIN_LR, MG_PRETRAIN_TOL = 16, 1e-4, 1e-4
PRETRAIN_READ = 2000  # corpus structures read for the card-vs-CPU steps
PRETRAIN_SAMPLES = 16
# SynScore's trainer: all 100 bags, SYN_STEPS steps card vs CPU, then timed
SYN_BAGS, SYN_N, SYN_STEPS, SYN_TIMED, SYN_LR = 100, 2000, 5, 20, 3e-3
# phase alignn: corpus structures beside phase predictor's 134; card vs CPU
# (both f32, TF32 off; the sums' order differs: atomics on the card) within
# 1e-4 of the output's scale, phase predictor's tolerance
ALIGNN_CORPUS, ALIGNN_TOL = 512, 1e-4
ALIGNN_CPU = 256  # the structures the CPU also scores (the record's 134 first)
# phase dp: two gloo ranks on one card, 64 crystals each family; the DDPO
# update at the DDPO recipe's lr, its weights within 1e-6 of the model's
# weight scale of one process's (the CPU test's bound)
DP_RANKS, DP_BATCH, DP_MAX_ATOMS, DP_SEED, DP_LR, DP_UPDATE_TOL = 2, 64, 8, 0, 3e-5, 1e-6
DP_CHUNK = 50  # transitions per DDPO step, the DDPO recipes'
# the ranks' gathered samples against their blocks sampled in turn in one
# process: the same computation at the same shapes
DP_SAME_TOL = 1e-6
# the ranks' gathered trajectories against one process's whole batch over
# the chain's first DP_PREFIX steps (2 score-net evaluations each), before
# the T=1000 chain amplifies the GEMMs' rounding at other row counts: the
# score net's card tolerance (NET_TOL), 100 times the per-evaluation gap of
# a rank's rows against the whole batch (2e-6 of scale, _dp_net_parity);
# DiffCSP's lattice and type logits times the gain its schedule gives them
# over those steps (_diffcsp_gain: 1,000 under the cosine schedule)
DP_PREFIX, DP_PREFIX_TOL = 10, 2e-4
DIFFCSP_GAINED = ("lattices", "next_lattices", "atom_types", "next_atom_types")
# the tools: distillation from the demo teacher at the archived run's widths
# (h128/L4, T=100, batch 64, cap 8) for DISTILL_STEPS steps; one step card
# against CPU on the same batch, weights and targets: the loss within 1e-4
# relative, every gradient entry within DISTILL_GRAD_TOL of the largest, the
# card's weights after the step within 1e-6 of their scale of the CPU's
# AdamW step taken on the card's own gradient (every entry), and of the
# CPU's own step where the gradient lies above its f32 noise (1e-6 of its
# norm; below it Adam's first step lr g / (|g| + eps) turns the gradients'
# rounding into up to lr: those entries are reported, not gated)
DISTILL_CORPUS = ROOT / "experiments/results/dataset.extxyz"
DISTILL_ARGS = dict(hidden=128, layers=4, timesteps=100, batch=64, max_atoms=8, seed=0,
                    sample_check_n=32)
DISTILL_STEPS, DISTILL_LOSS_TOL, DISTILL_WEIGHT_TOL = 200, 1e-4, 1e-6
DISTILL_GRAD_TOL = 1e-4
# the reward ceiling: the predictor rewards over the first CEILING_N designs
# on the card, the first CEILING_CPU of them (for the smoke's time limit)
# against the CPU within 1e-5 (rewards lie in [0, 1]); heat capacity on
# CEILING_HEAT designs of its pick through the bridge's worker, against
# JAX's
CEILING_REWARDS, CEILING_N, CEILING_TOL, CEILING_HEAT = ("magnetic_density", "gap_bulk"), 2048, 1e-5, 8
CEILING_CPU = 512
# phase edge_shapes: MatterGen models of random weights (seeded, scaled by
# EDGE_SHAPES_SCALE as the CPU tests scale theirs, so the chains stay
# finite), f32, at shapes the kernel's tiled instances do not take, which
# its wide route runs: EDGE_SHAPES_RUNS of experiments/edge_cycles.py
# (name, hidden, max_atoms, crystals, buckets, histogram over atom counts),
# h384/L6 in 2 buckets (every bucket on the wide route), h256/L6 at
# max_atoms 72 in 3 buckets, the last capped above 64 (it alone on the wide
# route). Every bucket launches the kernel as the plan says. T is cut to 50
# for time. Each bucket's first score-net eval against the plain net within
# NET_TOL of max(1, scale), and its final crystals against a plain-net run
# on the same draws: atom types equal, fractional coordinates (circular)
# and lattices within EDGE_SHAPES_TOL. The wide route is also timed alone
# at EDGE_SHAPES_WIDER widths on the h384 run's bucket shapes (the widest,
# 640, is the widest f32 layout at 10 frequencies)
EDGE_SHAPES_T, EDGE_SHAPES_SCALE, EDGE_SHAPES_TOL = 50, 0.02, 1e-3
EDGE_SHAPES_WIDER = (512, 640)
DEV = "cuda"
BATCH, BUCKETS, MAX_ATOMS, SEED = 256, 4, 20, 0
# phase sampling's plain edge path runs the kernel run's bucket plan and
# draws for its first steps only (for the smoke's time limit), held there
# as phase dp holds its prefix: early states, before the chain amplifies
# rounding
SAMPLING_PREFIX = 10
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


def check_path_kernel(plans, H: int, nf: int) -> dict:
    """``fused_edge_chain`` against its plain version at a path's own
    shapes: one call per (atom counts, cap) of ``plans`` at width ``H``,
    f32 and bf16, on random card inputs padded as the path pads them; the
    largest error of each dtype (``check_close``'s tolerance)."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    errs = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        errs[f"max_abs_err_{tag}"] = max(
            check_kernel(*edge_inputs(len(na), cap, H, nf, dtype, gen,
                                      torch.as_tensor(na, device=DEV)), nf)
            for na, cap in plans)
    return dict(shapes=[[len(na), cap, H] for na, cap in plans], **errs)


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
    """``fused_edge <mode> <dtype> H=<H>``, ``fused_edge full wide
    <dtype> R=<rows> KT=<tile rows> NS=<stages>``, ``edge_flat bf16
    H=256``, or the mangled name of an instance nvcc reported."""
    m = _EDGE_INSTANCE.search(mangled)
    if m:
        dtype = "bf16" if m.group(1) != "f" else "f32"
        return f"fused_edge {_EDGE_MODE[m.group(3, 4, 5)]} {dtype} H={m.group(2)}"
    m = re.search(r"fused_edge_wide_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if m:
        dtype = "bf16" if m.group(1) != "f" else "f32"
        return f"fused_edge full wide {dtype} R={m.group(2)} KT={m.group(3)} NS={m.group(4)}"
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
    # the wide route's depends on the shape (phase edge_shapes reads it)
    return lambda inst: None if " wide " in inst else lib.fused_edge_smem_bytes(
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


class PrefixStates:
    """While active, keeps each bucket's state (cell, coordinates, types;
    by its cap) and atom mask after the first ``steps`` grid steps of
    ``model``'s sampling; with ``stop`` it ends the sampling there once
    every cap of ``caps`` has its state (the exit swallows that stop)."""

    class Stop(Exception):
        pass

    def __init__(self, model, steps: int, caps, stop: bool = False):
        self.model, self.steps, self.caps, self.stop = model, steps, set(caps), stop
        self.states = {}

    def __enter__(self):
        step = self.model._sample_step

        def kept(carry, i, *args, **kwargs):
            out = step(carry, i, *args, **kwargs)
            if i == self.steps - 1:
                mask = kwargs["mask"]
                self.states[int(mask.shape[1])] = (tuple(x.clone() for x in out[0]), mask.clone())
                if self.stop and set(self.states) == self.caps:
                    raise PrefixStates.Stop
            return out

        self.model._sample_step = kept
        return self

    def __exit__(self, exc_type, *exc):
        del self.model._sample_step  # the instance attribute: the method again
        return exc_type is PrefixStates.Stop


def prefix_gaps(got: dict, ref: dict) -> dict:
    """Per bucket (cap): the largest gap of the cells over max(1, scale),
    of the real atoms' fractional coordinates (circular) and the real
    atoms' type flips, between two ``PrefixStates.states``."""
    gaps = {}
    for cap, ((cell, pos, types), mask) in got.items():
        (rcell, rpos, rtypes), _ = ref[cap]
        d = (pos - rpos)[mask]
        gaps[cap] = dict(
            cell=float((cell - rcell).abs().max()) / max(1.0, float(rcell.abs().max())),
            frac_coords=float((d - torch.round(d)).abs().max()),
            type_flips=int((types != rtypes)[mask].sum()))
    return gaps


def phase_sampling(model) -> dict:
    """256 crystals at T=1000 in the model's ``sample_dtype`` through the
    kernel (every launch counted), and the plain edge path on the same
    bucket plan and draws for the first ``SAMPLING_PREFIX`` steps: each
    bucket's state there against the kernel run's. f32: within
    ``DP_PREFIX_TOL`` of scale and no type flip. bf16: within twice the
    plain path's own bf16-against-f32 gap over those steps (at least
    ``DP_PREFIX_TOL``), type flips at most twice the plain path's."""
    c = model.config
    counts, caps = bucket_shapes()
    if len(caps) != BUCKETS:
        raise AssertionError(f"expected {BUCKETS} buckets, got caps {caps}")
    expected = model.planned_launches() * len(caps)
    fused_edge_chain.launches = 0
    with PrefixStates(model, SAMPLING_PREFIX, caps) as kernel:
        seconds, valid = sample_once(model, fused_edge=True)
    launches = fused_edge_chain.launches
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    t0 = time.perf_counter()
    with PrefixStates(model, SAMPLING_PREFIX, caps, stop=True) as plain:
        sample_once(model, fused_edge=False)
    plain_seconds = time.perf_counter() - t0
    gaps = prefix_gaps(kernel.states, plain.states)
    if c.sample_dtype == "float32":
        tol = {cap: dict(cell=DP_PREFIX_TOL, frac_coords=DP_PREFIX_TOL, type_flips=0)
               for cap in caps}
    else:
        # the plain path in f32 on the same draws, for its own bf16 spread
        model.config = dataclasses.replace(c, sample_dtype="float32")
        try:
            with PrefixStates(model, SAMPLING_PREFIX, caps, stop=True) as f32:
                sample_once(model, fused_edge=False)
        finally:
            model.config = c
        spread = prefix_gaps(plain.states, f32.states)
        tol = {cap: {k: max(2 * v, DP_PREFIX_TOL) if k != "type_flips" else 2 * v
                     for k, v in spread[cap].items()} for cap in caps}
    if sorted(gaps) != sorted(caps) or any(
            gaps[cap][k] > tol[cap][k] for cap in caps for k in gaps[cap]):
        raise AssertionError(f"kernel vs plain after {SAMPLING_PREFIX} steps: {gaps} > {tol}")
    rec = dict(
        phase="sampling", batch=BATCH, timesteps=c.timesteps, caps=caps,
        crystals=[len(x) for x in counts], dtype=c.sample_dtype,
        kernel_launches=launches, seconds=seconds, structures_per_s=BATCH / seconds,
        valid_share=valid / BATCH, prefix_steps=SAMPLING_PREFIX, prefix_gaps=gaps,
        prefix_tol=tol, plain_prefix_seconds=plain_seconds,
    )
    emit(rec)
    return rec


class FirstEvals:
    """While active, records the first score-net eval of each bucket (by
    its cap) that ``model`` makes: its inputs, whether it ran the edge
    kernel, and its outputs."""

    def __init__(self, model):
        self.model, self.evals = model, {}

    def __enter__(self):
        apply_net = self.orig = self.model.apply_net

        def recorded(noised, num_atoms, mask, *args, **kwargs):
            out = apply_net(noised, num_atoms, mask, *args, **kwargs)
            cap = int(mask.shape[1])
            if cap not in self.evals:
                self.evals[cap] = dict(
                    inputs=(MGNoised(*(x.clone() for x in noised)), num_atoms.clone(), mask.clone()),
                    fused_edge=bool(kwargs.get("fused_edge")),
                    out={k: v.clone() for k, v in out.items()})
            return out

        self.model.apply_net = recorded
        return self

    def __exit__(self, *exc):
        del self.model.apply_net  # the instance attribute: the method again


class BucketOutputs:
    """While active, keeps the per-bucket crystals that
    ``MatterGenDiffusion.sample_bucketed`` returns (``outputs``, in call
    order)."""

    def __enter__(self):
        self.outputs = []
        self._orig = bucketed = MatterGenDiffusion.sample_bucketed

        def kept(model, *args, **kwargs):
            out = bucketed(model, *args, **kwargs)
            self.outputs.append(out)
            return out

        MatterGenDiffusion.sample_bucketed = kept
        return self

    def __exit__(self, *exc):
        MatterGenDiffusion.sample_bucketed = self._orig


def time_path_kernel(plans, H: int, nf: int) -> dict:
    """``fused_edge_chain`` at a path's bucket shapes (random card inputs
    padded as the path pads them): per dtype the summed device time of one
    layer-eval over the buckets, launched from Python, of the plain version
    and of the chain of PyTorch ops, the bound of the same work and the
    kernel's share of it (bound over time)."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    row = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        keys = ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms")
        acc = dict.fromkeys(keys, 0.0)
        for na, cap in plans:
            num_atoms = torch.as_tensor(na, device=DEV)
            args, _ = edge_inputs(len(na), cap, H, nf, dtype, gen, num_atoms)
            acc["ms"] += time_ms(lambda: fused_edge_chain(*args, num_freqs=nf), 50)
            acc["eager_ms"] += eager_ms(lambda: fused_edge_chain(*args, num_freqs=nf), 50)
            acc["plain_ms"] += time_ms(lambda: fused_edge_chain_plain(*args, num_freqs=nf), 10)
            acc["library_ms"] += time_ms(lambda: library_chain(args, nf), 10)
            b, row[f"{tag}_bound_by"] = bound(args, num_atoms, nf)
            acc["bound_ms"] += b
        row.update({f"{tag}_{k}": v for k, v in acc.items()})
        row[f"{tag}_share_of_bound"] = acc["bound_ms"] / acc["ms"]
    return row


def phase_edge_shapes() -> dict:
    """The edge kernel's wide route in the sampler, on the card, for each of
    ``EDGE_SHAPES_RUNS``: every bucket launches the kernel as the plan says
    (``planned_launches``; the route follows the bucket's shape), each
    bucket's first score-net eval ran the kernel and matches the plain net
    on the same inputs within ``NET_TOL`` of max(1, scale), the chains stay
    finite, and each bucket's final crystals match those of a plain-net run
    on the same draws (``EDGE_SHAPES_TOL``); the kernel is held against its
    plain version at the buckets' shapes, and timed there, and at the h384
    buckets also at ``EDGE_SHAPES_WIDER`` widths; the wide route's layout on
    the card equals the rule's."""
    t0 = time.perf_counter()
    runs = {}
    for name, hidden, max_atoms, n, buckets, hist in EDGE_SHAPES_RUNS:
        register_num_atoms_distribution(f"edge_shapes_{name}", hist)
        torch.manual_seed(EDGE_SHAPES_SEED)
        model = MatterGenDiffusion(MatterGenConfig(hidden_dim=hidden, num_layers=6,
                                                   timesteps=EDGE_SHAPES_T), device=DEV).eval()
        with torch.no_grad():
            for prm in model.parameters():
                prm.mul_(EDGE_SHAPES_SCALE)
        nf = model.config.num_freqs

        def sampler(fused):
            return MatterGenSampler(batch_size=n, num_batches=1, max_atoms=max_atoms,
                                    num_atoms_distribution=f"edge_shapes_{name}",
                                    size_buckets=buckets, seed=EDGE_SHAPES_SEED, fused_edge=fused)

        torch.cuda.synchronize()
        fused_edge_chain.launches = 0
        with SampleCalls() as calls, FirstEvals(model) as first, BucketOutputs() as kept:
            t = time.perf_counter()
            sampler(True).launch(model)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
        launches = fused_edge_chain.launches
        with BucketOutputs() as kept_plain:
            t = time.perf_counter()
            sampler(False).launch(model)
            torch.cuda.synchronize()
            plain_seconds = time.perf_counter() - t
        plans, evals = calls.plans, first.evals
        caps = [cap for _, cap in plans]
        wide = [not tiled(hidden, cap, 6 * nf) for cap in caps]
        expected = model.planned_launches() * len(caps)
        if len(caps) != buckets or launches != expected or len(kept.outputs) != 1:
            raise AssertionError(f"edge_shapes {name}: caps {caps}, {launches} launches, "
                                 f"plan {expected}")
        if not all(kernel_takes(hidden, cap, nf, torch.float32) for cap in caps) or (
                wide != ([True] * buckets if name == "h384" else [False] * (buckets - 1) + [True])):
            raise AssertionError(f"edge_shapes {name}: caps {caps}, wide route {wide}")
        first_errs, final_errs = {}, {}
        for bi, (cap, got, ref) in enumerate(zip(caps, kept.outputs[0], kept_plain.outputs[0])):
            ev = evals[cap]
            if not ev["fused_edge"]:
                raise AssertionError(f"edge_shapes {name}: cap {cap} ran the plain net")
            with torch.no_grad():
                plain = model.apply_net(*ev["inputs"], fused_edge=False)
            mask = ev["inputs"][2]
            first_errs[cap] = {}
            for k, r in plain.items():
                g = ev["out"][k]
                if r.shape[:2] == mask.shape:
                    g, r = g[mask], r[mask]
                scale = max(1.0, float(r.abs().max()))
                first_errs[cap][k] = float((g - r).abs().max()) / scale
                if not torch.isfinite(g).all() or first_errs[cap][k] > NET_TOL:
                    raise AssertionError(f"edge_shapes {name} cap {cap} {k}: first eval vs "
                                         f"plain {first_errs[cap][k]} of scale")
            m = torch.arange(cap, device=DEV)[None, :] < got.num_atoms[:, None]
            finite = bool(torch.isfinite(got.frac_coords).all() and torch.isfinite(got.lattice).all())
            fd = (got.frac_coords - ref.frac_coords)[m]
            final_errs[cap] = dict(
                finite=finite,
                types_equal=bool(torch.equal(got.atom_types[m], ref.atom_types[m])),
                frac_coords=float((fd - torch.round(fd)).abs().max()),
                lattice_of_scale=float((got.lattice - ref.lattice).abs().max())
                / max(1.0, float(ref.lattice.abs().max())))
            e = final_errs[cap]
            if not (finite and e["types_equal"] and e["frac_coords"] <= EDGE_SHAPES_TOL
                    and e["lattice_of_scale"] <= EDGE_SHAPES_TOL):
                raise AssertionError(f"edge_shapes {name} bucket {bi} (cap {cap}): final "
                                     f"crystals vs the plain run {e}")
        kernel = check_path_kernel(plans, hidden, nf)
        wide_plans = [pl for pl, w in zip(plans, wide) if w]
        timing = time_path_kernel(wide_plans, hidden, nf)
        if name == "h384":  # the kernel alone at wider widths, same buckets
            wider = {}
            for h in EDGE_SHAPES_WIDER:
                if not all(kernel_takes(h, cap, nf, dt) for _, cap in wide_plans
                           for dt in (torch.float32, torch.bfloat16)):
                    raise AssertionError(f"edge_shapes: the kernel does not take h{h}")
                wider[f"h{h}"] = dict(kernel_vs_plain=check_path_kernel(wide_plans, h, nf),
                                      timing=time_path_kernel(wide_plans, h, nf))
        runs[name] = dict(hidden=hidden, layers=6, timesteps=EDGE_SHAPES_T, crystals=n,
                          caps=caps, wide_route=wide, kernel_launches=launches,
                          expected_launches=expected, first_eval_vs_plain_of_scale=first_errs,
                          final_vs_plain=final_errs, kernel_vs_plain=kernel,
                          wide_buckets_timing=timing, sample_seconds=seconds,
                          plain_sample_seconds=plain_seconds)
        del model
    runs["h384"]["wider"] = wider
    # the wide route's layout on the card (rows per chunk, bytes) against the
    # rule's, at the phase's widths, the widest of each dtype's layouts and
    # past them, and at 88 frequencies
    lib = build("fused_edge").lib
    for fn in (lib.fused_edge_wide_smem_bytes, lib.fused_edge_wide_rows):
        fn.argtypes = [ctypes.c_int] * 3
    layouts = {}
    for h, lanes in [(256, 60), (384, 60), (512, 60), (640, 60), (641, 60), (1280, 60),
                     (1281, 60), (256, 528)]:
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            rule = wide_layout(h, lanes, dtype)
            card = (lib.fused_edge_wide_rows(h, lanes, code),
                    lib.fused_edge_wide_smem_bytes(h, lanes, code))
            if card != ((-1, -1) if rule is None else (rule[0], rule[3])):
                raise AssertionError(f"wide layout at h{h}, {lanes} lanes, {dtype}: card "
                                     f"{card}, rule {rule}")
            layouts[f"h{h}_lanes{lanes}_{str(dtype)[6:]}"] = rule
    rec = dict(phase="edge_shapes", runs=runs, tol=NET_TOL, final_tol=EDGE_SHAPES_TOL,
               weight_scale=EDGE_SHAPES_SCALE, wide_layouts=layouts,
               seconds=time.perf_counter() - t0)
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
    expected = model.planned_launches() * len(caps)
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
        expected = pipe.agent.planned_launches()
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
            mat_invent.resolve("rl_hhi_rich5", 2, ["pipeline.async_sampling=true", *MG_STEPS_SETS]),
            out)
        expected = pipe.agent.planned_launches()
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

        # the predictor-training CLI as a user runs it (on the card), its
        # checkpoint reloaded on the card and on the CPU
        work = Path(tmp)
        save_extxyz(train, str(work / "tool_data.extxyz"))
        np.savetxt(work / "tool_labels.txt", labels)
        t1 = time.perf_counter()
        tool = train_predictor_tool.main([
            f"data={work / 'tool_data.extxyz'}", f"labels={work / 'tool_labels.txt'}",
            f"model_name={TRAIN_MODEL}", f"output_dir={work / 'tool'}", f"steps={TOOL_STEPS}"])
        tool_seconds = time.perf_counter() - t1
        held = [train[i] for i in tool["val_index"]]
        reloaded = {dev: PropertyGNN(TRAIN_MODEL, model_dir=work / "tool", device=dev)
                    for dev in (DEV, "cpu")}
        if not all(g.loaded for g in reloaded.values()):
            raise AssertionError("the tool's checkpoint did not load")
        tool_err = check_values(reloaded[DEV].predict(held), reloaded["cpu"].predict(held),
                                PRED_TOL * reloaded["cpu"].y_std, 0.0, "train_predictor reload")
        meta = dict(line.split("=", 1) for line in
                    (work / "tool" / f"{TRAIN_MODEL}.meta.txt").read_text().splitlines())
        if list(meta) != ["val_r2", "val_mae", "steps", "y_mean", "y_std", "labels"] \
                or not all(map(math.isfinite, tool["losses"])) \
                or not np.mean(tool["losses"][-5:]) < np.mean(tool["losses"][:5]) \
                or not math.isfinite(tool["val_r2"]):
            raise AssertionError(f"train_predictor: {meta}, losses {tool['losses']}")
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
        train_predictor=dict(steps=TOOL_STEPS, val_r2=tool["val_r2"], val_mae=tool["val_mae"],
                             first_loss=tool["losses"][0], last_loss=tool["losses"][-1],
                             ms_per_step=1e3 * tool["train_seconds"] / TOOL_STEPS,
                             seconds=tool_seconds, reload_card_vs_cpu=tool_err,
                             reload_tol=PRED_TOL),
        seconds=time.perf_counter() - t0,
    )
    emit(rec)
    return rec


def phase_rl_mag() -> dict:
    """Two rl_mag_rich_dense iterations as the entry point builds them, on
    the card, in a temporary directory, on the ``MG_STEPS`` grid: the
    plan's edge kernels each, a finite
    magnetic-density mean scored on the card, ``time_score_s`` per
    iteration, and the archived JAX run's ``metrics.csv`` columns."""
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_rl_mag_")
    root = logging.getLogger()
    level, log = root.level, LogRecords()
    root.setLevel(logging.INFO)
    root.addHandler(log)
    try:
        pipe = mat_invent.build(mat_invent.resolve("rl_mag_rich_dense", 2, MG_STEPS_SETS), out)
        calc = pipe.reward.prop_cfg[0]["calculator"]
        if not isinstance(calc, PropertyPredictor) or calc.device.type != torch.device(DEV).type:
            raise AssertionError(f"the reward's calculator is {calc!r}, not a predictor on the card")
        expected = pipe.agent.planned_launches()
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


def _diffcsp_net_gap(card, cpu, what: str) -> float:
    """The largest gap over the output's max(1, scale) of a DiffCSP score
    net on the card against the same net on the CPU, on 64 random inputs;
    raises beyond ``NET_TOL``."""
    c = cpu.config
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
        ref = cpu.apply_net(inputs, na, mask)
        got = card.apply_net(NoisedInput(*(x.to(DEV) for x in inputs)), na.to(DEV), mask.to(DEV))
    gap = 0.0
    for name, g, r in zip(("lattice", "coords", "types"), got, ref):
        err = (g.cpu() - r).abs()
        if r.dim() == 3 and r.shape[1] == A:
            err = err * mask[..., None]
        rel = err.max().item() / max(1.0, r.abs().max().item())
        if not rel <= NET_TOL:
            raise AssertionError(f"DiffCSP score net ({what}) {name}: card vs cpu {rel} > {NET_TOL}")
        gap = max(gap, rel)
    return gap


def phase_diffcsp() -> dict:
    """``experiments/results/pretrained`` through ``DiffCSPSuite``: the f32
    score net on the card against the CPU on the same inputs, and so the
    net with ``ip=False``, ``use_dis_emb=False`` and both on random weights
    at the checkpoint's width (h128/L4); 128 crystals
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
    A = DIFFCSP_MAX_ATOMS
    net_err = _diffcsp_net_gap(model, cpu_model, "the checkpoint")
    del cpu_model
    # the options no in-repo checkpoint sets, on random weights at the
    # checkpoint's width: ip=False (the raw lattice; a DiffCSP config
    # field), CSPNet's use_dis_emb=False (the raw coordinate differences; no
    # DiffCSP config sets it, as in the JAX package, so the net is built
    # directly), and both
    def with_options(ip, dis, device):
        m = DiffCSPDiffusion(dataclasses.replace(c, ip=ip), device=device)
        if not dis:
            m.decoder = CSPNet(hidden_dim=c.hidden_dim, latent_dim=c.time_dim,
                               num_layers=c.num_layers, max_atoms=c.max_atomic_num,
                               num_freqs=c.num_freqs, ln=c.ln, smooth=True, pred_type=True,
                               ip=ip, use_dis_emb=False).to(device)
        return m

    options = {}
    for ip, dis in ((False, True), (True, False), (False, False)):
        torch.manual_seed(1)
        cpu_opt = with_options(ip, dis, "cpu")
        card_opt = with_options(ip, dis, DEV)
        card_opt.load_state_dict(cpu_opt.state_dict())
        options[f"ip={ip},use_dis_emb={dis}"] = _diffcsp_net_gap(
            card_opt, cpu_opt, f"ip={ip}, use_dis_emb={dis}")

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
               options_net_max_rel_err=options,
               batch=DIFFCSP_BATCH, max_atoms=A, timesteps=c.timesteps,
               sample_clip=DIFFCSP_CLIP, sample_seconds=sample_seconds,
               structures_per_s=DIFFCSP_BATCH / sample_seconds, validity=shares,
               sample_peak_memory_bytes=peak, iteration=it,
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def phase_ddpo(name: str, recipe: str, sets=()) -> dict:
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
            pipe = mat_invent.build(mat_invent.resolve(recipe, 2, list(sets)), out)
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
                clip = agent.config.sample_clip
                clipped = (None if clip is None
                           else (cells.abs() >= clip).float().mean().item())
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


def _circular(a: Structure, b: Structure) -> float:
    return float(np.abs((a.frac_coords - b.frac_coords + 0.5) % 1.0 - 0.5).max())


def _relax_pair(structs, steps: int):
    """Card and CPU relaxations of ``structs``: the card's structures and
    energies, the largest circular coordinate and lattice gaps and the
    energies' relative gaps per structure, and the card's seconds."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    card, e = SoftSphereRelaxer(steps=steps, max_atoms=20, device=DEV)(structs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    cpu, e_ref = SoftSphereRelaxer(steps=steps, max_atoms=20, device="cpu")(structs)
    gaps = [max(_circular(a, b), float(np.abs(a.lattice - b.lattice).max()))
            for a, b in zip(card, cpu)]
    e_gaps = [abs(x - y) / max(abs(y), 1e-12) for x, y in zip(e, e_ref)]
    return card, np.asarray(e), gaps, e_gaps, seconds


def phase_relax_phonon() -> dict:
    """The relaxer and the native phonon / elastic workflows on the card
    against the CPU, with TF32 allowed (they must not depend on it):

    * 32 ``corpus_r5`` structures and the JAX tests' LiF and PbS relaxed:
      every one within 1e-4 (circular coords, lattice; energies relative)
      after 1 step; the descent is unstable on most corpus structures, so
      from the second step the card's and the CPU's rounding part them
      (the shares that agree at 2 and 200 steps are reported), and at the
      default 200 steps only LiF and PbS must agree;
    * the Hessian of a 64-atom supercell within 1e-4 of its largest entry;
    * C_v and the bulk modulus within 1e-3 (``phonon_pair``: C_v once the
      floor modes are accounted for, the bulk modulus where both scale
      searches end alike), of LiF and PbS through the whole workflow and
      of 6 small corpus structures as given (supercells of at most
      ``PHONON_SUPERCELL`` atoms);
    * the whole heat-capacity and bulk-modulus workflows on the card for
      all 34 (the MLIP worker's defaults): seconds per structure, peak
      memory and the NaN share (fails if every value is NaN)."""
    t0 = time.perf_counter()
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        corpus = read_extxyz(str(CORPUS), limit=PHONON_CORPUS)
        sym = [rocksalt(4.0, 3, 9), rocksalt(5.9, 82, 16)]
        structs = corpus + sym
        _, _, gaps, e_gaps, _ = _relax_pair(structs, 1)
        if max(gaps) > 1e-4 or max(e_gaps) > 1e-4:
            raise AssertionError(f"relaxer at 1 step: card vs cpu {max(gaps)}, {max(e_gaps)}")
        tracked = {}
        for steps in (2, 200):
            _, energies, gaps, e_gaps, relax_seconds = _relax_pair(structs, steps)
            tracked[steps] = [g <= 1e-4 and eg <= 1e-4 for g, eg in zip(gaps, e_gaps)]
        if not all(tracked[200][-2:]):
            raise AssertionError(f"relaxer at 200 steps: LiF/PbS card vs cpu {gaps[-2:]}")

        sc = phonon.supercell(rocksalt(3.8, 11, 17), (2, 4, 4))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        h = phonon.pair_hessian(sc, torch.device(DEV))
        torch.cuda.synchronize()
        hess_seconds = time.perf_counter() - t1
        hess_peak = torch.cuda.max_memory_allocated()
        ref = phonon.pair_hessian(sc, torch.device("cpu"))
        hess_err = float((h.cpu() - ref).abs().max() / ref.abs().max())
        if not hess_err <= 1e-4:
            raise AssertionError(f"the {sc.num_atoms}-atom Hessian: card vs cpu {hess_err}")

        small = [s for s in corpus if s.num_atoms <= 6][:6]
        pairs = [phonon_pair(s, True, 160) for s in sym]
        pairs += [phonon_pair(s, False, PHONON_SUPERCELL) for s in small]
        for p in pairs:
            if not (p["cv_gap"] <= 1e-3 and (p["bm_gap"] is None or p["bm_gap"] <= 1e-3)):
                raise AssertionError(f"phonon workflows card vs cpu: {p}")
        if sum(p["bm_gap"] is not None for p in pairs) < len(pairs) - 2:
            raise AssertionError(f"the scale searches end apart on most structures: {pairs}")

        workflows = {}
        for name, fn in (("heat_capacity", phonon.gamma_heat_capacity),
                         ("bulk_modulus", phonon.soft_sphere_bulk_modulus)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            v = fn(structs, device=DEV)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t1
            nan_share = float(np.mean(~np.isfinite(v)))
            if nan_share == 1.0:
                raise AssertionError(f"every {name} is NaN")
            workflows[name] = dict(seconds_per_structure=sec / len(structs), nan_share=nan_share,
                                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                                   mean=float(np.nanmean(v)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    rec = dict(phase="relax_phonon", structures=len(structs),
               relax_seconds_200_steps=relax_seconds,
               relax_tracked={k: f"{sum(v)}/{len(v)}" for k, v in tracked.items()},
               relaxed_energy_mean=float(np.mean(energies)),
               hessian_atoms=sc.num_atoms, hessian_seconds=hess_seconds,
               hessian_peak_memory_bytes=hess_peak, hessian_rel_err=hess_err,
               card_vs_cpu=pairs, workflows=workflows, seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def phase_rl_heat() -> dict:
    """Two ``rl_heat_capacity_t1000`` iterations as the entry point builds
    them, on the card, in a temporary directory: 128 crystals of
    ``pretrained_mattergen_t1000`` on its ``MG_STEPS`` grid through the
    edge kernel (the plan's launches), the invalid filter, the MLIP bridge's heat-capacity
    worker on the card (its stderr names the native backend), memory,
    replay and the reward-weighted fine-tune; a finite reward mean."""
    t0 = time.perf_counter()

    def run(log):
        out = tempfile.mkdtemp(prefix="chip_smoke_rl_heat_")
        try:
            pipe = mat_invent.build(mat_invent.resolve("rl_heat_capacity_t1000", 2, MG_STEPS_SETS),
                                    out)
            calc = pipe.reward.prop_cfg[0]["calculator"]
            if not isinstance(calc, MLIPBridge) or calc.device.type != torch.device(DEV).type:
                raise AssertionError(f"the reward's calculator is {calc!r}, not the bridge on the card")
            c = pipe.agent.config
            # the kernel at each iteration's bucket shapes, drawn from a copy
            # of the sampler as its launches will draw them
            plan_sampler = copy.deepcopy(pipe.sampler)
            total = pipe.sample_cfg["batch_size"] * pipe.sample_cfg["num_batches"]
            plans, expected = [], []
            for _ in range(pipe.rl_epoch):
                na = plan_sampler._draw_num_atoms(total)
                cuts, caps = plan_sampler.bucket_plan(na)
                plans += [(na[idx], cap) for idx, cap in zip(cuts, caps)]
                expected.append(pipe.agent.planned_launches() * len(caps))
            kernel = check_path_kernel(plans, c.hidden_dim, c.num_freqs)
            iters = []
            for step in range(pipe.rl_epoch):
                pipe.step = step
                it = _iteration(pipe, log, pipe.rl_step)
                row = pipe.logger.rows[-1]
                it["heat_capacity_mean"] = row.get("heat_capacity mean")
                # _iteration clears the log first: this iteration's lines
                it["worker_log"] = [m for m in log.messages if m.startswith("[mlip/")]
                iters.append(it)
            for it, want in zip(iters, expected):
                if it["kernel_launches"] != want or want == 0:
                    raise AssertionError(f"iteration {it['step']}: {it['kernel_launches']} "
                                         f"launches, not {want}")
                if not math.isfinite(float(it["reward_mean"])):
                    raise AssertionError(f"iteration {it['step']}: reward mean {it['reward_mean']}")
                if not any("backend: native" in m for m in it["worker_log"]):
                    raise AssertionError(f"iteration {it['step']}: worker log {it['worker_log']}")
            return iters, kernel
        finally:
            shutil.rmtree(out, ignore_errors=True)

    iters, kernel = _run_logged(run)
    rec = dict(phase="rl_heat", recipe="rl_heat_capacity_t1000", kernel_vs_plain=kernel,
               iterations=iters, seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def phase_csp() -> dict:
    """CSP mode: 64 crystals of two compositions at T=1000 from
    ``pretrained_mattergen_t1000`` (``sample_clip`` 30, as its recipes),
    unbucketed through the edge kernel; every row's types equal its
    composition; their validity shares."""
    t0 = time.perf_counter()
    model = load_model(MG_T1000, device=DEV, config_overrides={"sample_clip": 30.0})
    sampler = MatterGenSampler(batch_size=CSP_BATCH, num_batches=1, max_atoms=8, seed=SEED,
                               size_buckets=BUCKETS, target_compositions_dict=CSP_COMPOSITIONS)
    types, na = sampler._composition_batch(CSP_BATCH)
    c = model.config
    # one padded batch of the compositions' counts at cap max_atoms
    kernel = check_path_kernel([(na, sampler.max_atoms)], c.hidden_dim, c.num_freqs)
    fused_edge_chain.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    batch = sampler.launch(model)
    torch.cuda.synchronize()
    sample_seconds = time.perf_counter() - t1
    launches = fused_edge_chain.launches
    if launches != model.planned_launches():
        raise AssertionError(f"CSP sampling launched the edge kernel {launches} times")
    if not (np.array_equal(batch.atom_types.cpu().numpy(), types)
            and np.array_equal(batch.num_atoms.cpu().numpy(), na)):
        raise AssertionError("the sampled types differ from the compositions")
    if not torch.isfinite(batch.lattice).all():
        raise AssertionError("CSP lattices are not finite")
    _, strucs = batch_to_structures(batch)
    rec = dict(phase="csp", checkpoint=str(MG_T1000.relative_to(ROOT)),
               compositions=CSP_COMPOSITIONS, batch=CSP_BATCH, kernel_vs_plain=kernel,
               kernel_launches=launches,
               sample_seconds=sample_seconds, validity=measure_validity(strucs),
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def phase_knn() -> dict:
    """``pretrained_mattergen_t1000`` with ``edge_style: knn``: its f32
    score net on the card against the CPU within 2e-4 of scale, then 64
    crystals on the ``MG_STEPS`` grid, which sample on the plain net (the edge kernel
    takes fc edges only): no kernel launch."""
    t0 = time.perf_counter()
    over = {"edge_style": "knn", "sample_clip": 30.0, "timesteps": MG_STEPS}
    model = load_model(MG_T1000, device=DEV, config_overrides=over)
    cpu_model = load_model(MG_T1000, device="cpu", config_overrides=over)
    c = model.config
    rng = np.random.default_rng(0)
    B, A = 64, 8
    na = torch.from_numpy(rng.integers(1, A + 1, B))
    mask = torch.arange(A)[None, :] < na[:, None]
    x = MGNoised(
        torch.full((B,), 0.5), torch.from_numpy(rng.normal(size=(B, c.time_dim)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 100, (B, A))),
        torch.from_numpy(rng.uniform(size=(B, A, 3)).astype(np.float32)),
        torch.from_numpy((np.eye(3) * 4.0 + rng.normal(size=(B, 3, 3)) * 0.3).astype(np.float32)),
    )
    with torch.no_grad():
        ref = cpu_model.apply_net(x, na, mask)
        got = model.apply_net(MGNoised(*(v.to(DEV) for v in x)), na.to(DEV), mask.to(DEV))
    net_err = 0.0
    for k, r in ref.items():
        err = (got[k].cpu() - r).abs()
        if r.dim() == 3 and r.shape[1] == A:
            err = err * mask[..., None]
        rel = err.max().item() / max(1.0, r.abs().max().item())
        if not rel <= NET_TOL:
            raise AssertionError(f"knn score net {k}: card vs cpu {rel} > {NET_TOL}")
        net_err = max(net_err, rel)
    del cpu_model
    sampler = MatterGenSampler(batch_size=KNN_BATCH, num_batches=1, max_atoms=A, seed=SEED,
                               size_buckets=BUCKETS)
    fused_edge_chain.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    batch = sampler.launch(model)
    torch.cuda.synchronize()
    sample_seconds = time.perf_counter() - t1
    launches = fused_edge_chain.launches
    if launches != 0:
        raise AssertionError(f"the knn model launched the fc edge kernel {launches} times")
    if not torch.isfinite(batch.lattice).all():
        raise AssertionError("knn lattices are not finite")
    _, strucs = batch_to_structures(batch)
    rec = dict(phase="knn", checkpoint=str(MG_T1000.relative_to(ROOT)), cutoff=c.cutoff,
               max_neighbors=c.max_neighbors, net_max_rel_err=net_err, net_tol=NET_TOL,
               batch=KNN_BATCH, kernel_launches=launches, sample_seconds=sample_seconds,
               validity=measure_validity(strucs), seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


class SampleCalls:
    """Records the buckets of every MatterGen sampling call while active
    (``sample`` samples one padded batch, ``sample_bucketed`` one per
    cap), each as (atom counts, cap): ``plans``, the plan the edge kernel's
    launches follow and the shapes they take."""

    def __enter__(self):
        self.plans = []
        self._orig = sample, bucketed = MatterGenDiffusion.sample, MatterGenDiffusion.sample_bucketed

        def plan(na, cap):
            cap = 20 if cap is None else int(cap)  # sample's default cap
            self.plans.append((np.minimum(torch.as_tensor(na).cpu().numpy(), cap), cap))

        def counted(model, noise, num_atoms, *args, **kwargs):
            plan(num_atoms, args[0] if args else kwargs.get("max_atoms"))
            return sample(model, noise, num_atoms, *args, **kwargs)

        def counted_bucketed(model, gen, na_buckets, caps, *args, **kwargs):
            for na, cap in zip(na_buckets, caps):
                plan(na, cap)
            return bucketed(model, gen, na_buckets, caps, *args, **kwargs)

        MatterGenDiffusion.sample, MatterGenDiffusion.sample_bucketed = counted, counted_bucketed
        return self

    def __exit__(self, *exc):
        MatterGenDiffusion.sample, MatterGenDiffusion.sample_bucketed = self._orig


def _drive(fn, cwd_back: str):
    """``fn()`` (an entry point) with the launch count set to 0 just before
    and read just after, the pipeline's log captured and the working
    directory restored; (result, launches, planned buckets as (atom counts,
    cap), seconds, messages)."""
    def run(log):
        torch.cuda.synchronize()
        fused_edge_chain.launches = 0
        with SampleCalls() as calls:
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
        return out, fused_edge_chain.launches, calls.plans, seconds, list(log.messages)

    try:
        return _run_logged(run)
    finally:
        os.chdir(cwd_back)


def _check_launches(name: str, launches: int, plans: list, model) -> int:
    expected = model.planned_launches() * len(plans)
    if launches != expected or launches == 0:
        raise AssertionError(f"{name}: {launches} edge-kernel launches, the bucket plan "
                             f"({len(plans)} buckets) gives {expected}")
    return expected


def phase_main() -> dict:
    """``python -m matinvent_tpu_torch.main`` as a user runs it: ``model=
    mattergen`` from the start checkpoint, the HHI reward, one iteration,
    ``configs/``'s defaults otherwise (the base ``OptFilter`` with the
    disordered matcher, 64 samples, ``max_num`` 16, replay, the diversity
    filter, 3 epochs of 20 chunks of 50). The edge kernel's launches equal
    the sampler's plan; the artifacts of JAX's ``main``; a finite reward
    and finite fine-tune losses; the agent moved."""
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_main_")
    try:
        pipe, launches, plans, seconds, messages = _drive(
            lambda: entry_main.main([*MAIN_ARGS, f"results_dir={out}", "expname=main"]),
            os.getcwd())
        run = Path(out) / "main"
        if not isinstance(pipe, mat_invent.MatInvent) or pipe.agent.device.type != torch.device(DEV).type:
            raise AssertionError(f"main built {type(pipe).__name__} on {pipe.agent.device}")
        if type(pipe.filter.matcher).__name__ != "DisorderedStructureMatcher":
            raise AssertionError(f"the base filter's matcher is {pipe.filter.matcher!r}")
        expected = _check_launches("main", launches, plans, pipe.agent)
        hp = read_yaml(run / "hparams.yaml")
        if hp["model"]["_target_"] != "matinvent_tpu_torch.models.suite.mattergen.MatterGenSuite":
            raise AssertionError(f"hparams.yaml model target {hp['model']['_target_']}")
        for rel in ("metrics.csv", "samples/step_0000_valid.extxyz", "samples/step_0000_eval.extxyz",
                    "samples/long_term_memory.csv", "models/final/params.msgpack"):
            if not (run / rel).is_file():
                raise AssertionError(f"main wrote no {rel}")
        row = pipe.logger.rows[-1]
        losses = [float(v) for m in messages for v in re.findall(r"loss\w*: (\S+?)(?:,|$)", m)]
        if not math.isfinite(float(row.get("reward mean", "nan"))) or not losses or \
                not all(map(math.isfinite, losses)):
            raise AssertionError(f"reward mean {row.get('reward mean')}, losses {losses}")
        start = load_model(START, device=DEV)
        if all(torch.equal(v, pipe.agent.state_dict()[k]) for k, v in start.state_dict().items()):
            raise AssertionError("the fine-tune left the agent at the start checkpoint")
        valid = [int(v) for m in messages for v in re.findall(r"Number of valid samples: (\d+)", m)]
        filtered = [int(v) for m in messages
                    for v in re.findall(r"Number of filtered samples: (\d+)", m)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    rec = dict(phase="main", args=MAIN_ARGS, kernel_launches=launches, expected_launches=expected,
               buckets=len(plans), valid=valid, filtered=filtered, reward_mean=row.get("reward mean"),
               finetune_losses=losses, seconds_run=seconds,
               **{k: row.get(k) for k in ("time_sample_s", "time_score_s", "time_finetune_s")},
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def phase_baseline() -> dict:
    """The same with ``pipeline=baseline``: sampling and scoring only; the
    launches follow the plan, no model is saved, and the agent is bit-equal
    to the start checkpoint afterwards."""
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_baseline_")
    try:
        pipe, launches, plans, seconds, messages = _drive(
            lambda: entry_main.main([*MAIN_ARGS, "pipeline=baseline", f"results_dir={out}",
                                     "expname=baseline"]), os.getcwd())
        run = Path(out) / "baseline"
        if not isinstance(pipe, Baseline):
            raise AssertionError(f"pipeline=baseline built {type(pipe).__name__}")
        expected = _check_launches("baseline", launches, plans, pipe.agent)
        start = load_model(START, device=DEV)
        if any(not torch.equal(v, pipe.agent.state_dict()[k]) for k, v in start.state_dict().items()):
            raise AssertionError("Baseline changed the agent's weights")
        if (run / "models" / "final").exists() or not (run / "samples/step_0000_valid.extxyz").is_file():
            raise AssertionError("Baseline's artifacts differ from JAX's")
        row = pipe.logger.rows[-1]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    rec = dict(phase="baseline", kernel_launches=launches, expected_launches=expected,
               buckets=len(plans), reward_mean=row.get("reward mean"), crystal_num=row.get("crystal_num"),
               seconds_run=seconds, seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def phase_gen_eval() -> dict:
    """``python -m matinvent_tpu_torch.gen_eval`` with the 1024 record's
    arguments at ``GEN_EVAL_BATCHES`` x 64 crystals: the start checkpoint,
    ``corpus_r5`` as the reference, its hull and its atom-count histogram,
    relaxation on the card, both matcher tiers. ``metrics.json`` has the
    record's keys and fractions in [0, 1]; the launches (a warm launch and
    the timed ones) follow the plan; structures per second."""
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_gen_eval_")
    try:
        args = ["model=mattergen", f"model.model_path={START}", f"output_dir={out}",
                f"batch_size={GEN_EVAL_BATCH}", f"num_batches={GEN_EVAL_BATCHES}",
                f"reference_path={CORPUS}", f"reference_energies={CORPUS_ENERGIES}", "relax=true",
                f"num_atoms_from={CORPUS}", "structure_matcher=disordered,ordered"]
        metrics, launches, plans, seconds, _ = _drive(lambda: entry_gen_eval.main(args),
                                                        os.getcwd())
        expected = _check_launches("gen_eval", launches, plans, load_model(START, device="cpu"))
        with open(GEN_EVAL_RECORD) as fh:
            record = json.load(fh)
        if set(metrics) != set(record) or set(metrics["by_matcher"]) != set(record["by_matcher"]):
            raise AssertionError(f"metrics.json keys {sorted(metrics)} != {sorted(record)}")
        fracs = [v for tier in metrics["by_matcher"].values() for v in tier.values()]
        if not all(0.0 <= v <= 1.0 for v in fracs) or metrics["num_generated"] != \
                GEN_EVAL_BATCH * GEN_EVAL_BATCHES:
            raise AssertionError(f"gen_eval metrics {metrics}")
        written = read_extxyz(str(Path(out) / "generated_crystals.extxyz"))
        if len(written) != GEN_EVAL_BATCH * GEN_EVAL_BATCHES:
            raise AssertionError(f"{len(written)} structures written")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    rec = dict(phase="gen_eval", metrics=metrics, kernel_launches=launches,
               expected_launches=expected, buckets=len(plans), seconds_run=seconds,
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def _adam_close(a: dict, b: dict, lr: float, what: str) -> tuple[float, float]:
    """(largest difference, share of entries beyond lr / 100) of two
    weight sets after one Adam step; raises past 2 lr or a 1% share."""
    worst, loose, total = 0.0, 0, 0
    for k, v in b.items():
        d = (a[k].detach().cpu().double() - v.detach().cpu().double()).abs()
        worst = max(worst, float(d.max()))
        loose += int((d > lr / 100).sum())
        total += d.numel()
    if worst > 2 * lr or loose > 0.01 * total:
        raise AssertionError(f"{what}: weights after the step differ by {worst} "
                             f"({loose} of {total} entries beyond lr/100)")
    return worst, loose / total


def _step_card_vs_cpu(card, cpu, batch, given: dict, lr: float, tol: float, what: str) -> dict:
    """One ``PretrainTrainer`` step of the same weights on the card and on
    the CPU with the same draws ``given``; their loss and gradient norm
    within ``tol`` relative, their weights after the step by
    ``_adam_close``."""
    out = {}
    for tag, model in (("card", card), ("cpu", cpu)):
        dev = next(model.parameters()).device
        trainer = PretrainTrainer(model, lr=lr)
        moved = {k: (v.to(dev) if torch.is_tensor(v) else
                     type(v)(*(x.to(dev) for x in v))) for k, v in given.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = trainer.step(trainer.optimizer(), 0, batch, **moved)
        out[tag] = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        out[f"{tag}_seconds"] = time.perf_counter() - t
    for k in ("loss", "grad_norm"):
        a, b = out["card"][k], out["cpu"][k]
        if not math.isfinite(a) or abs(a - b) > tol * abs(b):
            raise AssertionError(f"{what}: card {k} {a} vs CPU {b} (tolerance {tol} relative)")
    worst, share = _adam_close(card.state_dict(), cpu.state_dict(), lr, what)
    return dict(loss_card=out["card"]["loss"], loss_cpu=out["cpu"]["loss"],
                grad_norm_card=out["card"]["grad_norm"], grad_norm_cpu=out["cpu"]["grad_norm"],
                weights_max_abs_diff=worst, weights_share_beyond_lr_100=share,
                card_step_seconds=out["card_seconds"], cpu_step_seconds=out["cpu_seconds"])


def phase_pretrain() -> dict:
    """Pretraining on the card, launching no edge kernel (the plain net
    trains): DiffCSP at ``configs/model/diffcsp.yaml``'s width, one step on
    the card against the CPU on numpy's draws (the first 2,000 corpus
    structures' batches); ``tools.pretrain`` on
    ``corpus_r5`` (batch 128, 50 steps): the loss curve, ms per step, peak
    memory; its checkpoint loads into ``DiffCSPSuite`` with equal weights
    and samples 16 crystals; then MatterGen's ``training_loss`` step at
    h256/L6 (the start checkpoint, batch 16), card against CPU."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    fused_edge_chain.launches = 0
    structures = read_extxyz(str(CORPUS), limit=PRETRAIN_READ)
    rng = np.random.default_rng(5)
    model_cfg = load_config(ROOT / "configs", "base", ["model=diffcsp"])["model"]["model_cfg"]
    card = DiffCSPSuite(model_cfg=model_cfg, sample_cfg={"max_atoms": MAX_ATOMS}, seed=0,
                        device=DEV).load_model()
    cpu = DiffCSPDiffusion(card.config, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = next(structures_to_batches(structures, PRETRAIN_BATCH, MAX_ATOMS, rng))
    B, A, K = PRETRAIN_BATCH, MAX_ATOMS, card.config.max_atomic_num

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    csp_given = dict(t=torch.from_numpy(rng.integers(1, card.config.timesteps + 1, B)),
                     draws=CSPNoiseDraws(normal(B, 3, 3), normal(B, A, 3), normal(B, A, K)))
    diffcsp_step = _step_card_vs_cpu(card, cpu, batch, csp_given, PRETRAIN_LR, NET_TOL,
                                     "DiffCSP step")
    del card, cpu

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    timed: dict = {}
    train = PretrainTrainer.train

    def timed_train(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = train(self, *args, **kwargs)
        torch.cuda.synchronize()
        timed["seconds"] = time.perf_counter() - t
        return result

    try:
        torch.cuda.reset_peak_memory_stats()
        PretrainTrainer.train = timed_train
        try:
            model, history = _run_logged(lambda log: pretrain_tool.main([
                f"data={CORPUS}", f"output_dir={ckpt}", f"steps={PRETRAIN_STEPS}",
                f"batch_size={PRETRAIN_BATCH}", f"max_atoms={MAX_ATOMS}"]))
        finally:
            PretrainTrainer.train = train
        peak = torch.cuda.max_memory_allocated()
        curve = [h["loss"] for h in history]
        if len(curve) != PRETRAIN_STEPS or not all(map(math.isfinite, curve)) \
                or np.mean(curve[-5:]) >= curve[0]:
            raise AssertionError(f"pretraining loss curve {curve}")
        files = sorted(os.listdir(ckpt))
        if files != ["config.yaml", "params.msgpack", "state_dict.npz"]:
            raise AssertionError(f"the checkpoint holds {files}")
        cfg_back = read_flat_yaml(Path(ckpt) / "config.yaml")
        if any(cfg_back[k] != v for k, v in model_cfg.items()):
            raise AssertionError(f"config.yaml {cfg_back} vs {model_cfg}")
        with np.load(Path(ckpt) / "state_dict.npz") as npz:
            torch_layout = sorted(npz.files)
        suite = DiffCSPSuite(model_path=ckpt, sample_cfg={"max_atoms": MAX_ATOMS},
                             config_overrides={"sample_clip": DIFFCSP_CLIP}, device=DEV)
        loaded = suite.load_model()
        if any(not torch.equal(v, model.state_dict()[k]) for k, v in loaded.state_dict().items()):
            raise AssertionError("the saved checkpoint loads to other weights")
        t = time.perf_counter()
        sampled = DiffCSPSampler(batch_size=PRETRAIN_SAMPLES, num_batches=1, max_atoms=MAX_ATOMS,
                                 seed=0).launch(loaded)
        torch.cuda.synchronize()
        sample_seconds = time.perf_counter() - t
        if sampled.frac_coords.shape != (PRETRAIN_SAMPLES, MAX_ATOMS, 3) or \
                not torch.isfinite(sampled.lattice).all():
            raise AssertionError("the pretrained checkpoint's samples are not finite")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    card = load_model(START, device=DEV)
    cpu = load_model(START, device="cpu")
    Bm, T = MG_PRETRAIN_BATCH, card.config.timesteps
    mg_batch = next(structures_to_batches(structures, Bm, MAX_ATOMS, rng))
    mg_given = dict(
        t=torch.from_numpy(rng.uniform(1.0 / T, 1.0, Bm).astype(np.float32)),
        draws=NoiseDraws(normal(Bm, 3, 3), normal(Bm, A, 3),
                         torch.from_numpy(rng.gumbel(size=(Bm, A, card.d3pm.vocab)).astype(np.float32))))
    mattergen_step = _step_card_vs_cpu(card, cpu, mg_batch, mg_given, MG_PRETRAIN_LR,
                                       MG_PRETRAIN_TOL, "MatterGen step")
    torch.cuda.synchronize()
    launches = fused_edge_chain.launches
    if launches != 0:
        raise AssertionError(f"pretraining launched {launches} edge kernels")
    rec = dict(phase="pretrain", kernel_launches=launches, diffcsp_step=diffcsp_step,
               diffcsp_width=model_cfg, steps=PRETRAIN_STEPS, batch=PRETRAIN_BATCH,
               loss_curve=curve, ms_per_step=1e3 * timed["seconds"] / PRETRAIN_STEPS,
               train_seconds=timed["seconds"], peak_memory_bytes=peak,
               state_dict_npz_keys=len(torch_layout), samples=PRETRAIN_SAMPLES,
               sample_seconds=sample_seconds, mattergen_step=mattergen_step,
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def phase_syn_score_train() -> dict:
    """``tools/train_syn_score``'s ensemble update over all 100 bags on the
    card against the CPU: the same initial weights and bootstrap columns,
    ``SYN_STEPS`` Adam steps (each loss within 1e-5 relative, the weights
    by ``_adam_close`` per step); then ms per step on the card and the
    folded ensemble's validation accuracy and AUC."""
    t0 = time.perf_counter()
    data = train_syn_score.prepare(SYN_N, 0, SYN_BAGS)
    n_train = data["boots"].shape[1]
    init = train_syn_score.init_params(SYN_BAGS, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(9)
    cols = [rng.integers(0, n_train, (SYN_BAGS, train_syn_score.BATCH)) for _ in range(SYN_STEPS)]
    params = {tag: {k: v.to(dev).clone() for k, v in init.items()}
              for tag, dev in (("card", DEV), ("cpu", "cpu"))}
    losses = {tag: train_syn_score.train_ensemble(p, data["Xtr"], data["ytr"], data["boots"],
                                                  SYN_STEPS, SYN_LR, cols=cols)
              for tag, p in params.items()}
    for a, b in zip(losses["card"], losses["cpu"]):
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"SynScore trainer losses card {losses['card']} cpu {losses['cpu']}")
    worst, share = _adam_close(params["card"], params["cpu"], SYN_STEPS * SYN_LR, "SynScore trainer")
    gen = torch.Generator(device=DEV).manual_seed(1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    train_syn_score.train_ensemble(params["card"], data["Xtr"], data["ytr"], data["boots"],
                                   SYN_TIMED, SYN_LR, generator=gen)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t) / SYN_TIMED
    acc, auc = train_syn_score.validate(train_syn_score.fold(params["card"], data["mu"], data["sd"]),
                                        data["Xva_raw"], data["yva"], DEV)
    rec = dict(phase="syn_score_train", bags=SYN_BAGS, n=SYN_N, n_train=n_train,
               steps_compared=SYN_STEPS, losses_card=losses["card"], losses_cpu=losses["cpu"],
               weights_max_abs_diff=worst, weights_share_beyond_lr_100=share,
               ms_per_step=ms, val_acc=acc, val_auc=auc, seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def alignn_state_dict(spec: ALIGNNSpec, rng: np.random.Generator) -> dict:
    """Random weights of an ALIGNNAtomWise at ``spec``'s widths under the
    published state-dict names, BatchNorm running statistics included:
    linear weights N(0, 1/fan_in), as an initialized net scales them."""
    sd = {}

    def lin(name, nin, nout):
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.normal(0, nin ** -0.5, (nout, nin)).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(rng.normal(0, 0.01, nout).astype(np.float32))

    def bn(name, n):
        sd[f"{name}.weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32))
        sd[f"{name}.running_mean"] = torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32))
        sd[f"{name}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

    def mlp(name, nin, nout):
        lin(f"{name}.layer.0", nin, nout)
        bn(f"{name}.layer.1", nout)

    H, E = spec.hidden_features, spec.embedding_features
    mlp("atom_embedding", spec.atom_input_features, H)
    sd["edge_embedding.0.centers"] = torch.linspace(0, 8, spec.edge_input_features)
    mlp("edge_embedding.1", spec.edge_input_features, E)
    mlp("edge_embedding.2", E, H)
    sd["angle_embedding.0.centers"] = torch.linspace(-1, 1, spec.triplet_input_features)
    mlp("angle_embedding.1", spec.triplet_input_features, E)
    mlp("angle_embedding.2", E, H)
    convs = [f"alignn_layers.{i}.{part}" for i in range(spec.alignn_layers)
             for part in ("node_update", "edge_update")]
    convs += [f"gcn_layers.{i}" for i in range(spec.gcn_layers)]
    for prefix in convs:
        for part in ("src_gate", "dst_gate", "edge_gate", "src_update", "dst_update"):
            lin(f"{prefix}.{part}", H, H)
        bn(f"{prefix}.bn_edges", H)
        bn(f"{prefix}.bn_nodes", H)
    lin("fc", H, spec.output_features)
    return sd


def write_alignn_folder(root: Path, seed: int = 0) -> Path:
    """An HF-layout ALIGNN model folder under ``root`` at the published
    widths (``ALIGNNSpec``'s defaults, ALIGNNAtomWise's), weights and a
    binary 92-feature atom table drawn from ``seed``: ``prop_pred/alignn/
    band_gap/{config.json, best_model.pt}`` and ``atom_init.json`` beside
    it; returns ``root``."""
    rng = np.random.default_rng(seed)
    spec = ALIGNNSpec()
    d = root / "prop_pred" / "alignn" / "band_gap"
    d.mkdir(parents=True, exist_ok=True)
    torch.save(alignn_state_dict(spec, rng), str(d / "best_model.pt"))
    cfg = {k: getattr(spec, k) for k in (
        "alignn_layers", "gcn_layers", "atom_input_features", "edge_input_features",
        "triplet_input_features", "embedding_features", "hidden_features",
        "output_features", "link", "classification")}
    (d / "config.json").write_text(json.dumps({"model": dict(name="alignn_atomwise", **cfg)}))
    table = {str(z): rng.integers(0, 2, spec.atom_input_features).astype(float).tolist()
             for z in range(1, 101)}
    (d / "atom_init.json").write_text(json.dumps(table))
    return root


def phase_alignn() -> dict:
    """The ALIGNN calculator at the published widths (4 ALIGNN and 4 GCN
    layers, hidden 256, BatchNorm) from random weights written in the HF
    folder layout in a temporary directory and read by ``alignn/load.py``:
    on phase ``predictor``'s 134 structures and ``ALIGNN_CORPUS`` corpus
    structures of up to 20 atoms, the card against the CPU on the first
    ``ALIGNN_CPU`` (the largest gap over the output's scale, ``ALIGNN_TOL``,
    same NaN entries); the host
    graph build's seconds per structure apart from the device forward's ms
    per chunk at ``chunk_size`` 16 and 128; structures per second through
    the calculator; peak device memory; the NaN share. Then one ``main``
    iteration with ``reward=band_gap_alignn`` on that folder: launches
    equal to the sampler's plan, the edge kernel against its plain version
    at the plan's shapes, the ``band_gap`` checkpoint loaded and a finite
    band gap for every structure it scored (their count and spread), a
    finite reward, ``time_score_s``."""
    t0 = time.perf_counter()
    folder = write_alignn_folder(Path(tempfile.mkdtemp(prefix="chip_smoke_alignn_model_")))
    try:
        with open(REWARD_RECORD) as fh:
            strucs = record_structures(json.load(fh))
        corpus = [x for x in read_extxyz(str(CORPUS), limit=4 * ALIGNN_CORPUS) if x.num_atoms <= 20]
        strucs += corpus[:ALIGNN_CORPUS]
        tmp = tempfile.mkdtemp(prefix="chip_smoke_alignn_")
        calc = ALIGNN(tmp, task="band_gap", model_dir=str(folder), device=DEV)
        t1 = time.perf_counter()
        model = calc._model("band_gap")
        torch.cuda.synchronize()
        load_seconds = time.perf_counter() - t1
        card = torch.device(DEV).type
        if model.spec != ALIGNNSpec() or model.atom_table.device.type != card or \
                any(v.device.type != card for v in model.params.values()):
            raise AssertionError(f"ALIGNN loaded as {model.spec} on {model.atom_table.device}")
        cpu = ALIGNNModel(str(folder / "prop_pred/alignn/band_gap"), device="cpu")
        card_out = model.predict(strucs)[:ALIGNN_CPU]
        cpu_out = cpu.predict(strucs[:ALIGNN_CPU])
        if not np.array_equal(np.isnan(card_out), np.isnan(cpu_out)):
            raise AssertionError("ALIGNN: NaN entries differ between the card and the CPU")
        fin = np.isfinite(cpu_out)
        scale = float(np.abs(cpu_out[fin]).max())
        gap = float(np.abs(card_out[fin] - cpu_out[fin]).max()) / scale
        if not fin.any() or gap > ALIGNN_TOL:
            raise AssertionError(f"ALIGNN card vs CPU {gap} of scale > {ALIGNN_TOL}")
        ok = [x for x in strucs if alignn_usable(x)]
        split = {}
        for chunk in (16, 128):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            host_s, fwd_ms, sizes = 0.0, [], []
            for lo in range(0, len(ok), chunk):
                t = time.perf_counter()
                batch = alignn_build_batch(ok[lo: lo + chunk])
                host_s += time.perf_counter() - t
                torch.cuda.synchronize()
                t = time.perf_counter()
                alignn_run_batch(model.params, model.spec, model.atom_table, batch)
                torch.cuda.synchronize()
                fwd_ms.append(1e3 * (time.perf_counter() - t))
                sizes.append(list(batch.padded_sizes))
            split[chunk] = dict(host_graph_s_per_structure=host_s / len(ok),
                                forward_ms_per_chunk=float(np.median(fwd_ms)),
                                forward_ms_first_chunk=fwd_ms[0], chunks=len(fwd_ms),
                                largest_padded_sizes=max(sizes, key=lambda z: z[2]),
                                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.synchronize()
        t = time.perf_counter()
        vals = calc.calc((strucs, None), "t")
        torch.cuda.synchronize()
        calc_seconds = time.perf_counter() - t
        shutil.rmtree(tmp, ignore_errors=True)

        out = tempfile.mkdtemp(prefix="chip_smoke_alignn_main_")
        try:
            args = [*(a for a in MAIN_ARGS if not a.startswith("reward=")), "reward=band_gap_alignn",
                    f"reward.prop_cfg.0.calculator.model_dir={folder}",
                    f"results_dir={out}", "expname=alignn"]
            # the band gaps the calculator predicts in the iteration
            predicted, predict = [], ALIGNNModel.predict

            def recorded(self, structures):
                vals = predict(self, structures)
                predicted.append(vals)
                return vals

            ALIGNNModel.predict = recorded
            try:
                pipe, launches, plans, seconds, _ = _drive(lambda: entry_main.main(args),
                                                           os.getcwd())
            finally:
                ALIGNNModel.predict = predict
            expected = _check_launches("alignn main", launches, plans, pipe.agent)
            c = pipe.agent.config
            kernel = check_path_kernel(plans, c.hidden_dim, c.num_freqs)
            calc_main = pipe.reward.prop_cfg[0]["calculator"]
            if type(calc_main).__name__ != "ALIGNN" or calc_main.device.type != card:
                raise AssertionError(f"main's reward calculator {calc_main!r}")
            gaps = np.concatenate(predicted) if predicted else np.zeros(0)
            if set(calc_main._models) != {"band_gap"} or \
                    calc_main._models["band_gap"].spec != ALIGNNSpec() or not len(gaps) or \
                    not np.isfinite(gaps).all():
                raise AssertionError(f"alignn main: models {sorted(calc_main._models)}, "
                                     f"band gaps {gaps}")
            row = pipe.logger.rows[-1]
            if not math.isfinite(float(row.get("reward mean", "nan"))):
                raise AssertionError(f"alignn main: reward mean {row.get('reward mean')}")
        finally:
            shutil.rmtree(out, ignore_errors=True)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    rec = dict(phase="alignn", spec=ALIGNNSpec().__dict__, structures=len(strucs),
               load_seconds=load_seconds, card_vs_cpu_of_scale=gap, tol=ALIGNN_TOL,
               compared_with_cpu=ALIGNN_CPU,
               output_scale=scale, split=split,
               structures_per_s=len(strucs) / calc_seconds, calc_seconds=calc_seconds,
               nan_share=float(np.isnan(vals).mean()),
               main=dict(kernel_launches=launches, expected_launches=expected, buckets=len(plans),
                         kernel_vs_plain=kernel, scored=len(gaps),
                         band_gap=dict(min=float(gaps.min()), max=float(gaps.max()),
                                       mean=float(gaps.mean()), std=float(gaps.std())),
                         reward_mean=row.get("reward mean"), seconds_run=seconds,
                         **{k: row.get(k) for k in ("time_sample_s", "time_score_s",
                                                    "time_finetune_s")}),
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _batch_gap(got: dict, want: dict) -> dict:
    """Atom-type flips (crystals whose types differ) and, over the other
    crystals, the largest coordinate (circular) and lattice gaps over the
    lattice's scale."""
    for k in ("frac_coords", "lattice"):
        if not (torch.isfinite(got[k]).all() and torch.isfinite(want[k]).all()):
            raise AssertionError(f"non-finite {k} in the data-parallel comparison")
    if not torch.equal(got["num_atoms"].long(), want["num_atoms"].long()):
        raise AssertionError("the gathered atom counts differ from one process's")
    flips = (got["atom_types"] != want["atom_types"]).any(dim=1)
    same = ~flips
    d = (got["frac_coords"] - want["frac_coords"]).abs()
    coords = float(torch.minimum(d, 1 - d)[same].max()) if same.any() else 0.0
    scale = float(want["lattice"].abs().max())
    lat = float((got["lattice"] - want["lattice"]).abs()[same].max()) / scale if same.any() else 0.0
    return dict(type_flips=[int(i) for i in torch.nonzero(flips).flatten()], coords=coords,
                lattice_of_scale=lat)


def _traj_prefix_gap(got: dict, want: dict, steps: int) -> dict:
    """Over a recorded trajectory's first ``steps`` steps, the largest gap
    of each state (log-probs and step indices aside) over its scale,
    coordinates circular, and the count of differing integer entries
    (atom types)."""
    out = {}
    for k, v in want.items():
        if k.startswith("log_prob") or k in ("step", "timestep"):
            continue
        a, b = got[k][:steps], v[:steps]
        if not v.is_floating_point():
            out[k] = int((a != b).sum())
            continue
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"non-finite {k} in the trajectory comparison")
        d = (a.double() - b.double()).abs()
        if "pos" in k or "frac_coords" in k:
            d = torch.minimum(d, 1 - d)
        out[k] = float(d.max()) / max(float(b.abs().max()), 1e-12)
    return out


def _diffcsp_gain(steps: int) -> float:
    """The gain of the DiffCSP checkpoint's chain on its lattice and type
    logits over its first ``steps`` steps: the product of each ancestral
    step's mean factor ``c0 = 1 / sqrt(alpha_t)`` (100 at t = T under the
    cosine schedule, then about (T - t + 1) / (T - t))."""
    model = DiffCSPSuite(model_path=str(DIFFCSP_CKPT), device="cpu").load_model()
    T = model.config.timesteps
    return math.prod(float(model._coefs(torch.tensor([T - i]), 1.0)["c0"].reshape(-1)[0])
                     for i in range(steps))


def _dp_net_parity() -> dict:
    """Each score net (DiffCSP; MatterGen plain and through the kernel) on
    ``DP_BATCH`` random rows against the same net on each rank's block of
    them: the per-evaluation gap that other GEMM shapes leave, within
    ``NET_TOL`` of the output's scale."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    B, A = DP_BATCH, DP_MAX_ATOMS
    na = torch.randint(1, A + 1, (B,), generator=gen, device=DEV)
    mask = torch.arange(A, device=DEV)[None, :] < na[:, None]
    csp = DiffCSPSuite(model_path=str(DIFFCSP_CKPT), device=DEV).load_model()
    mg = load_model(MG_T1000, device=DEV)
    c = csp.config
    csp_in = NoisedInput(
        sinusoidal_time_embedding(torch.randint(1, c.timesteps + 1, (B,), generator=gen,
                                                device=DEV), c.time_dim),
        torch.randn((B, A, c.max_atomic_num), generator=gen, device=DEV),
        torch.rand((B, A, 3), generator=gen, device=DEV),
        torch.eye(3, device=DEV)[None] * 5.0 + torch.randn((B, 3, 3), generator=gen, device=DEV))
    tables = mg._step_tables()
    i = mg.config.timesteps // 2
    mg_in = MGNoised(tables["t"][i].expand(B), tables["time_emb"][i][None].expand(B, -1),
                     torch.randint(0, mg.d3pm.vocab, (B, A), generator=gen, device=DEV),
                     torch.rand((B, A, 3), generator=gen, device=DEV),
                     torch.eye(3, device=DEV)[None] * 4.0
                     + 0.3 * torch.randn((B, 3, 3), generator=gen, device=DEV))
    nets = {
        "diffcsp": lambda x, n, m: dict(zip("lxt", csp.apply_net(x, n, m))),
        "mattergen_plain": lambda x, n, m: mg.apply_net(x, n, m, fused_edge=False),
        "mattergen_kernel": lambda x, n, m: mg.apply_net(x, n, m, fused_edge=True),
    }
    out = {}
    with torch.no_grad():
        for name, net in nets.items():
            x = csp_in if name == "diffcsp" else mg_in
            whole = net(x, na, mask)
            worst = 0.0
            for r in range(DP_RANKS):
                rows = Mesh(size=DP_RANKS, rank=r, device=torch.device(DEV)).rows(B)
                part = net(type(x)(*(v[rows] for v in x)), na[rows], mask[rows])
                for k, v in whole.items():
                    scale = max(float(v.abs().max()), 1e-12)
                    worst = max(worst, float((part[k] - v[rows]).abs().max()) / scale)
            if worst > NET_TOL:
                raise AssertionError(f"dp {name}: rows vs the whole batch {worst} of scale")
            out[name] = worst
    return out


def phase_dp() -> dict:
    """Data parallel. (a) ``python -m matinvent_tpu_torch.main`` as phase
    ``main`` runs it, in a child process that joins a one-rank NCCL group
    from ``MATINVENT_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID``.
    (b) Two ranks on the one card over ``gloo`` (NCCL refuses two ranks on
    one device), ``experiments/dp_check.py``: a recorded DiffCSP sample (the
    DiffCSP checkpoint, T=1000) and MatterGen samples
    (``pretrained_mattergen_t1000`` on its ``MG_STEPS`` grid, one through
    the edge kernel, one recorded) of ``DP_BATCH`` crystals, each rank
    sampling its rows, gathered and held against the same
    run in this process. The ranks' blocks sampled in turn in this process
    (the same shapes) hold them within ``DP_SAME_TOL`` of scale and with
    no type flip. Against the whole batch at once in this process: every
    row's draws equal, exactly (``dp_check.DrawSums``' checksums); the
    recorded trajectories' first ``DP_PREFIX`` steps within
    ``DP_PREFIX_TOL`` of scale (DiffCSP's lattice and type logits times
    their gain over those steps, ``_diffcsp_gain``) with no type flip; the
    final samples are reported beside, with their type flips named: the
    card's GEMMs round a row differently at twice the rows, and the long
    chain amplifies that. The per-evaluation gap is held
    too (``_dp_net_parity``: each score net on a rank's rows against the
    whole batch, within ``NET_TOL`` of scale). Each rank's edge-kernel
    launches equal its plan, and the kernel is held against its plain
    version at each rank's shapes; one MatterGen DDPO update of the
    recorded trajectory over the two ranks against this process's, the
    weights within ``DP_UPDATE_TOL`` of the model's weight scale."""
    t0 = time.perf_counter()
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    procs = []
    try:
        env = dict(os.environ, MATINVENT_COORDINATOR=f"127.0.0.1:{_free_port()}",
                   MATINVENT_NUM_PROCESSES="1", MATINVENT_PROCESS_ID="0")
        t = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "matinvent_tpu_torch.main", *MAIN_ARGS,
             f"results_dir={out}", "expname=dp_main"],
            env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=600)
        main_seconds = time.perf_counter() - t
        log = child.stdout + child.stderr
        if child.returncode != 0 or "backend nccl" not in log:
            raise AssertionError(f"dp main: exit {child.returncode}\n{log[-3000:]}")
        rows = (out / "dp_main" / "metrics.csv").read_text().splitlines()
        if len(rows) != 2 or not (out / "dp_main" / "models" / "final").is_dir():
            raise AssertionError(f"dp main wrote {rows}")
        joined = [ln for ln in log.splitlines() if "joined the process group" in ln]

        rng = np.random.default_rng(DP_SEED)
        mg_na = [int(v) for v in rng.integers(1, DP_MAX_ATOMS + 1, DP_BATCH)]
        rewards = rng.random(DP_BATCH).tolist()
        mg = {"family": "mattergen", "path": str(MG_T1000),
              "overrides": {"timesteps": MG_STEPS}}
        ddpo = dict(kind="ddpo", name="ddpo", model=mg, max_atoms=DP_MAX_ATOMS, rewards=rewards,
                    lr=DP_LR, chunk=DP_CHUNK, epochs=1, max_grad_norm=1.0)
        tasks = [
            dict(kind="diffcsp_sample", name="diffcsp",
                 model={"family": "diffcsp", "path": str(DIFFCSP_CKPT),
                        "overrides": {"sample_clip": DIFFCSP_CLIP}},
                 batch=DP_BATCH, max_atoms=DIFFCSP_MAX_ATOMS, step_lr=None, seed=DP_SEED,
                 record=True, traj_steps=DP_PREFIX, draws=True),
            dict(kind="mattergen_sample", name="mattergen", model=mg, num_atoms=mg_na,
                 max_atoms=DP_MAX_ATOMS, seed=DP_SEED, draws=True),
            dict(kind="mattergen_sample", name="recorded", model=mg, num_atoms=mg_na,
                 max_atoms=DP_MAX_ATOMS, seed=DP_SEED + 1, record=True, draws=True),
            dict(ddpo, traj_from="recorded"),
        ]
        job = {"device": "cuda", "backend": "gloo", "out": str(out / "ranks"), "tasks": tasks}
        (out / "job.json").write_text(json.dumps(job))
        t = time.perf_counter()
        procs = dp_check.start(out / "job.json", DP_RANKS, _free_port())
        # while the ranks run: the ranks' blocks in turn in this process, and
        # the whole batch in this process
        blocks = [dp_check.run_job(
            {**job, "out": str(out / f"block{r}"), "tasks": [dict(k, gather=False) for k in tasks[:3]]},
            Mesh(size=DP_RANKS, rank=r, device=torch.device(DEV))) for r in range(DP_RANKS)]
        ref = dp_check.run_job({**job, "out": str(out / "one"), "tasks": tasks[:3]})
        done = dp_check.wait(procs, timeout=900)
        ranks_seconds = time.perf_counter() - t
        for r, p in enumerate(done):
            if p.returncode != 0:
                raise AssertionError(f"dp rank {r}: exit {p.returncode}\n{p.stdout[-3000:]}")
        ranks = [{k["name"]: torch.load(str(out / "ranks" / f"{k['name']}.rank{r}.pt"),
                                        weights_only=True) for k in tasks}
                 for r in range(DP_RANKS)]
        # the DDPO update of the trajectory the ranks recorded, in this process
        ref.update(dp_check.run_job({**job, "out": str(out / "one"), "tasks": [
            dict(ddpo, traj=str(out / "ranks" / "recorded.rank0.pt"))]}))
        gaps, whole, prefix, draws, launches = {}, {}, {}, {}, []
        gain = _diffcsp_gain(DP_PREFIX)
        for name in ("diffcsp", "mattergen", "recorded"):
            serial = {k: torch.cat([b[name]["batch"][k] for b in blocks])
                      for k in ref[name]["batch"]}
            gaps[name] = _batch_gap(ranks[0][name]["batch"], serial)
            if gaps[name]["coords"] > DP_SAME_TOL or gaps[name]["lattice_of_scale"] > DP_SAME_TOL \
                    or gaps[name]["type_flips"]:
                raise AssertionError(f"dp {name}: gathered vs the blocks in one process {gaps[name]}")
            # the whole batch at once: the same draws, other GEMM shapes.
            # Every row drew what it draws there, exactly
            got, want = ranks[0][name]["draws"], ref[name]["draws"]
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"dp {name}: the ranks' draws differ from the whole batch's")
            draws[name] = list(want.shape)
            whole[name] = _batch_gap(ranks[0][name]["batch"], ref[name]["batch"])
            if "traj" in ref[name]:
                prefix[name] = _traj_prefix_gap(ranks[0][name]["traj"], ref[name]["traj"],
                                                DP_PREFIX)
                if any(v > (0 if isinstance(v, int) else
                            DP_PREFIX_TOL * (gain if k in DIFFCSP_GAINED else 1.0))
                       for k, v in prefix[name].items()):
                    raise AssertionError(f"dp {name}: the first {DP_PREFIX} steps against the "
                                         f"whole batch in one process {prefix[name]}")
        net = _dp_net_parity()
        # the edge kernel against its plain version at each rank's shapes
        c = mattergen_config(MG_T1000)
        rank_rows = [Mesh(size=DP_RANKS, rank=r, device=torch.device(DEV)).rows(DP_BATCH)
                     for r in range(DP_RANKS)]
        kernel = check_path_kernel([(np.asarray(mg_na)[rows], DP_MAX_ATOMS) for rows in rank_rows],
                                   c.hidden_dim, c.num_freqs)
        for r in range(DP_RANKS):
            k = ranks[r]["mattergen"]
            if k["launches"] != k["plan"] or k["launches"] == 0:
                raise AssertionError(f"dp rank {r}: {k['launches']} launches, plan {k['plan']}")
            launches.append(k["launches"])
        want = ref["ddpo"]["state"]
        scale = max(float(v.abs().max()) for v in want.values() if v.is_floating_point())
        update_gap = max(float((ranks[r]["ddpo"]["state"][k].double() - v.double()).abs().max())
                         for r in range(DP_RANKS) for k, v in want.items()) / scale
        replay = ranks[0]["ddpo"]["replay"]
        if update_gap > DP_UPDATE_TOL or abs(replay["ratio_mean"] - 1.0) > RATIO_TOL or \
                replay["clip_frac"] != 0.0:
            raise AssertionError(f"dp DDPO: weights {update_gap} of scale, replay {replay}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out, ignore_errors=True)
    rec = dict(phase="dp", main=dict(seconds=main_seconds, joined=joined),
               ranks=DP_RANKS, backend="gloo", batch=DP_BATCH, gaps=gaps, tol=DP_SAME_TOL,
               draw_checksums_equal=draws, whole_batch_gaps=whole, prefix_steps=DP_PREFIX,
               prefix_gaps=prefix, prefix_tol=DP_PREFIX_TOL, diffcsp_gain=gain,
               net_rows_vs_whole=net, net_tol=NET_TOL,
               kernel_launches_per_rank=launches, kernel_vs_plain=kernel,
               rank_sample_seconds=[ranks[r]["mattergen"]["seconds"] for r in range(DP_RANKS)],
               one_process_sample_seconds=ref["mattergen"]["seconds"],
               ddpo_weights_of_scale=update_gap, ddpo_tol=DP_UPDATE_TOL,
               ddpo_replay=replay, ddpo_epoch_stats=ranks[0]["ddpo"]["epoch_stats"],
               ddpo_epoch_stats_one=ref["ddpo"]["epoch_stats"],
               ranks_seconds=ranks_seconds, seconds=time.perf_counter() - t0)
    emit(rec)
    return rec



def phase_convert() -> dict:
    """The MatterGen converter both ways on ``pretrained_mattergen_t1000``,
    its template net on the card: ``to_torch`` then ``to_native`` give back
    the original ``params.msgpack`` byte for byte, the container's tensors
    equal the checkpoint's weights, and the converted directory loads to
    the original net."""
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_convert_"))
    try:
        t = time.perf_counter()
        ckpt = convert_tool.main(["to_torch", f"in={MG_T1000}", f"out={tmp / 'torch'}"])
        to_torch_seconds = time.perf_counter() - t
        t = time.perf_counter()
        convert_tool.main(["to_native", f"in={ckpt}", f"out={tmp / 'native'}"])
        to_native_seconds = time.perf_counter() - t
        if (tmp / "native/params.msgpack").read_bytes() != (MG_T1000 / "params.msgpack").read_bytes():
            raise AssertionError("convert: the round trip changed params.msgpack")
        original = load_model(MG_T1000, device=DEV).state_dict()
        container = torch.load(ckpt, map_location="cpu", weights_only=False)["state_dict"]
        again = load_model(tmp / "native", device=DEV).state_dict()
        if list(container) != sorted(original) or list(again) != list(original):
            raise AssertionError("convert: the parameter names differ")
        for k, v in original.items():
            if not (torch.equal(container[k], v.cpu()) and torch.equal(again[k], v)):
                raise AssertionError(f"convert: {k} differs after the round trip")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = dict(phase="convert", checkpoint=str(MG_T1000.relative_to(ROOT)), tensors=len(original),
               to_torch_seconds=to_torch_seconds, to_native_seconds=to_native_seconds,
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def _distill_step_card_vs_cpu() -> dict:
    """One distillation step from the same student weights on the card and
    on the CPU: the first training batch, corrupted on the CPU with numpy's
    draws, and the CPU teacher's targets handed to both."""
    a = DISTILL_ARGS
    rng = np.random.default_rng(7)
    batches = distill_tool.structure_batches(str(DISTILL_CORPUS), a["batch"], a["max_atoms"],
                                             np.random.default_rng(a["seed"]))
    batch = batches[max(len(batches) // 5, 1)]
    cfg = distill_tool.student_config(a["hidden"], a["layers"], a["timesteps"], 100)
    cpu = MatterGenDiffusion(cfg, device="cpu")
    card = MatterGenDiffusion(cfg, device=DEV)
    card.load_state_dict(cpu.state_dict())
    B, A, V = a["batch"], a["max_atoms"], cpu.d3pm.vocab
    draws = NoiseDraws(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                         for shape in ((B, 3, 3), (B, A, 3))),
                       torch.from_numpy(rng.gumbel(size=(B, A, V)).astype(np.float32)))
    t = torch.from_numpy(rng.uniform(1.0 / a["timesteps"], 1.0, B).astype(np.float32))
    with torch.no_grad():
        noised, _, _ = cpu.add_noise(batch, None, draws=draws, t=t)
    teacher = distill_tool.TorchTeacher(distill_tool.DemoTeacherNet.build(100, device="cpu"), 100)
    targets = distill_tool.teacher_targets(teacher, noised, batch.mask)
    replay = MatterGenDiffusion(cfg, device="cpu")
    replay.load_state_dict(cpu.state_dict())
    out, grads = {}, {}
    for tag, model in (("card", card), ("cpu", cpu)):
        dev = model.device
        m = distill_tool.distill_step(
            model, distill_tool.distill_optimizer(model, 1e-3), 0, 1e-3, DISTILL_STEPS,
            MGNoised(*(x.to(dev) for x in noised)), batch.to(dev),
            {k: v.to(dev) for k, v in targets.items()})
        out[tag] = {k: float(v) for k, v in m.items()}
        grads[tag] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    for k in ("loss", "cell", "pos", "type", "grad_norm"):
        c, r = out["card"][k], out["cpu"][k]
        if not math.isfinite(c) or abs(c - r) > DISTILL_LOSS_TOL * abs(r):
            raise AssertionError(f"distill step: card {k} {c} vs CPU {r}")
    norm = out["cpu"]["grad_norm"]
    grad_max = max(float(g.abs().max()) for g in grads["cpu"].values())
    grad_err = max(float((grads["card"][k] - g).abs().max()) for k, g in grads["cpu"].items())
    # the CPU's AdamW step on the card's gradient, from the same weights
    opt = distill_tool.distill_optimizer(replay, 1e-3)
    for k, p in replay.named_parameters():
        p.grad = grads["card"][k].clone()
    for group in opt.param_groups:
        group["lr"] = distill_tool.cosine_decay_lr(0, 1e-3, DISTILL_STEPS, distill_tool.LR_ALPHA)
    opt.step()
    card_sd, cpu_sd, replay_sd = card.state_dict(), cpu.state_dict(), replay.state_dict()
    scale = max(float(v.abs().max()) for v in cpu_sd.values())
    worst = worst_noisy = step_err = 0.0
    loose = total = 0
    for k, v in cpu_sd.items():
        c = card_sd[k].cpu().double()
        d = (c - v.double()).abs()
        noisy = grads["cpu"][k].abs() < 1e-6 * norm
        worst = max(worst, float(d[~noisy].max()) if (~noisy).any() else 0.0)
        worst_noisy = max(worst_noisy, float(d.max()))
        step_err = max(step_err, float((c - replay_sd[k].double()).abs().max()))
        loose += int((d > DISTILL_WEIGHT_TOL * scale).sum())
        total += d.numel()
    if (grad_err > DISTILL_GRAD_TOL * grad_max or step_err > DISTILL_WEIGHT_TOL * scale
            or worst > DISTILL_WEIGHT_TOL * scale):
        raise AssertionError(f"distill step: gradients differ by {grad_err} (largest {grad_max}), "
                             f"the step on the card's gradient by {step_err}, the weights by "
                             f"{worst} (scale {scale})")
    return dict(loss_card=out["card"]["loss"], loss_cpu=out["cpu"]["loss"],
                grad_norm_card=out["card"]["grad_norm"], grad_norm_cpu=norm,
                grad_max_abs_diff=grad_err, grad_max=grad_max,
                step_on_card_gradient_max_abs_diff=step_err,
                weights_max_abs_diff=worst, weights_max_abs_diff_at_noise=worst_noisy,
                weight_scale=scale, entries_beyond_tol=loose, entries=total)


def phase_distill() -> dict:
    """Score distillation as a user runs it (``python -m
    matinvent_tpu_torch.tools.distill_mattergen``): the demo teacher, the
    archived run's widths, ``DISTILL_STEPS`` steps on ``dataset.extxyz``, on
    the card. One step card against CPU first; kernel 1 against its plain
    version at the student sample's shapes; then the tool, with the launch
    count read around each part: the training and the teacher-scored
    sample launch nothing, the student's sample its plan (layers x 2 x T).
    The held-out student beats the untrained net by 2x on every field and
    the checkpoint loads through the port's suite."""
    t0 = time.perf_counter()
    a = DISTILL_ARGS
    step = _distill_step_card_vs_cpu()
    na = np.full(a["sample_check_n"], a["max_atoms"] // 2)
    kernel = check_path_kernel([(na, a["max_atoms"])], a["hidden"], 10)
    parts: dict = {}

    def counted(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            before, t = fused_edge_chain.launches, time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[name] = dict(launches=fused_edge_chain.launches - before,
                               seconds=time.perf_counter() - t)
            return out
        return run

    sample, teacher_sample = MatterGenDiffusion.sample, distill_tool.TeacherScoredDiffusion.sample
    distill, heldout = distill_tool.distill, distill_tool.heldout_match
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_distill_"))
    try:
        distill_tool.distill = counted("train", distill)
        distill_tool.heldout_match = counted("heldout", heldout)
        distill_tool.TeacherScoredDiffusion.sample = counted("teacher_sample", teacher_sample)
        MatterGenDiffusion.sample = lambda self, *args, **kwargs: (
            sample(self, *args, **kwargs) if type(self) is not MatterGenDiffusion
            else counted("student_sample", sample)(self, *args, **kwargs))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_edge_chain.launches = 0
        t = time.perf_counter()
        summary = distill_tool.main([f"{k}={v}" for k, v in a.items()] + [
            "teacher=demo", f"corpus={DISTILL_CORPUS}", f"out={out}", f"steps={DISTILL_STEPS}"])
        torch.cuda.synchronize()
        tool_seconds = time.perf_counter() - t
        launches = fused_edge_chain.launches
        peak = torch.cuda.max_memory_allocated()
        loaded = MatterGenSuite(model_path=str(out), device=DEV).load_model()
    finally:
        MatterGenDiffusion.sample, distill_tool.TeacherScoredDiffusion.sample = sample, teacher_sample
        distill_tool.distill, distill_tool.heldout_match = distill, heldout
        shutil.rmtree(out, ignore_errors=True)
    plan = loaded.planned_launches()
    if (plan == 0 or parts["student_sample"]["launches"] != plan or launches != plan
            or parts["train"]["launches"] or parts["teacher_sample"]["launches"]
            or parts["heldout"]["launches"]):
        raise AssertionError(f"distill: {launches} launches in all, by part {parts}; plan {plan}")
    m = summary["heldout_match"]
    for field in ("cell", "pos", "type_kl"):
        if not m["student_mse"][field] < 0.5 * m["untrained_baseline_mse"][field]:
            raise AssertionError(f"distill: held-out {field} {m}")
    if (loaded.config.hidden_dim, loaded.config.num_layers) != (a["hidden"], a["layers"]):
        raise AssertionError(f"distill: the checkpoint loads as {loaded.config}")
    rec = dict(phase="distill", settings=dict(a, steps=DISTILL_STEPS, teacher="demo"),
               step_card_vs_cpu=step, kernel_vs_plain=kernel, kernel_launches=launches,
               kernel_launches_train=parts["train"]["launches"],
               kernel_launches_teacher_sample=parts["teacher_sample"]["launches"],
               ms_per_step=1e3 * parts["train"]["seconds"] / DISTILL_STEPS,
               peak_memory_bytes=peak, heldout_match=m,
               sampled_statistics=summary["sampled_statistics"],
               part_seconds={k: v["seconds"] for k, v in parts.items()},
               tool_seconds=tool_seconds, seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def phase_reward_ceiling() -> dict:
    """The reward-ceiling tool's scoring on the card: ``magnetic_density``
    and ``gap_bulk`` over the first ``CEILING_N`` designs, the first
    ``CEILING_CPU`` card against CPU within ``CEILING_TOL`` per design
    (failures equal), every scored reward finite and the
    summary's statistics finite; heat capacity on ``CEILING_HEAT`` designs
    of its pick through the bridge's worker on the card (its log names the
    native backend): no NaN, each design held against JAX's record
    (``phonon_check.heat_against_jax``: within 1e-3 or a named flip, and
    the port's spectrum at JAX's equilibrated cell within 1e-3 of JAX's),
    seconds per design."""
    t0 = time.perf_counter()
    structures, meta = ceiling_tool.design_space()
    head, head_meta = structures[:CEILING_N], meta[:CEILING_N]
    valid = ceiling_tool.valid_mask(head)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ceiling_"))
    cwd = os.getcwd()
    rewards = {}

    def run(log):
        os.chdir(work)
        for name in CEILING_REWARDS:
            scored = {}
            for dev, rows in ((DEV, head), ("cpu", head[:CEILING_CPU])):
                reward, threshold = ceiling_tool.build_reward(name, dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                scored[dev] = ceiling_tool.score_all(reward, rows, f"ceiling_{name}_{dev}")
                torch.cuda.synchronize()
                scored[f"{dev}_seconds"] = time.perf_counter() - t
            (r, props, failed), (r_cpu, _, failed_cpu) = scored[DEV], scored["cpu"]
            err = float(np.abs(np.asarray(r, float)[:CEILING_CPU] - np.asarray(r_cpu, float)).max())
            if err > CEILING_TOL or not np.array_equal(np.asarray(failed)[:CEILING_CPU], failed_cpu):
                raise AssertionError(f"reward_ceiling {name}: card vs CPU {err}")
            summary = ceiling_tool.summarize(name, threshold, r, props, failed, valid, head_meta)
            ok = ~np.asarray(failed)
            if (summary["n_scored"] == 0 or not np.isfinite(np.asarray(r, float)[ok]).all()
                    or not all(math.isfinite(summary[k]) for k in ("max", "p95"))):
                raise AssertionError(f"reward_ceiling {name}: {summary}")
            rewards[name] = dict(card_vs_cpu=err, summary=summary,
                                 card_seconds=scored[f"{DEV}_seconds"],
                                 cpu_seconds=scored["cpu_seconds"],
                                 designs_per_second=CEILING_N / scored[f"{DEV}_seconds"])
        pick = ceiling_tool.heat_capacity_pick(structures)[:CEILING_HEAT]
        reward, _ = ceiling_tool.build_reward("heat_capacity", DEV)
        t = time.perf_counter()
        log.messages.clear()
        r, props, failed = ceiling_tool.score_all(reward, [structures[i] for i in pick],
                                                  "ceiling_heat_capacity")
        heat_seconds = time.perf_counter() - t
        if not any("backend: native" in msg for msg in log.messages):
            raise AssertionError(f"reward_ceiling heat_capacity: worker log {log.messages}")
        # the pick's first designs are the JAX record's first
        against = heat_against_jax([structures[i] for i in pick], props["heat_capacity"],
                                   range(len(pick)), DEV)
        nan_share = float(np.mean(failed))
        if nan_share or not against["ok"]:
            raise AssertionError(f"reward_ceiling heat_capacity: NaN share {nan_share}, "
                                 f"against JAX {against}")
        rewards["heat_capacity"] = dict(
            rewards=np.asarray(r, float).tolist(), nan_share=nan_share,
            against_jax=against, seconds_per_design=heat_seconds / len(pick))

    try:
        _run_logged(run)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    rec = dict(phase="reward_ceiling", designs=len(structures), scored=CEILING_N,
               cpu_scored=CEILING_CPU,
               rewards=rewards, seconds=time.perf_counter() - t0)
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
    edge = phase_edge_shapes()
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
            phase_ddpo("ddpo_mattergen", "rl_hhi_ddpo_mattergen_t1000", MG_STEPS_SETS)]
    phase_relax_phonon()
    rl_heat = phase_rl_heat()
    csp_mode = phase_csp()
    knn = phase_knn()
    ddpo.append(phase_ddpo("ddpo_cond", "rl_cond_ddpo", MG_STEPS_SETS))
    entry = {"main": phase_main(), "baseline": phase_baseline(), "gen_eval": phase_gen_eval()}
    pre = phase_pretrain()
    phase_syn_score_train()
    alignn = phase_alignn()
    dp = phase_dp()
    phase_convert()
    distilled = phase_distill()
    phase_reward_ceiling()
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    b = kern["buckets"]
    wide = edge["runs"]["h384"]["wide_buckets_timing"]
    wide_more = {"cap72": edge["runs"]["cap72"]["wide_buckets_timing"],
                 **{k: v["timing"] for k, v in edge["runs"]["h384"]["wider"].items()}}
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
        launches_rl_heat=[it["kernel_launches"] for it in rl_heat["iterations"]],
        launches_csp=csp_mode["kernel_launches"],
        # h384 (every bucket on the wide route) and max_atoms 72 (the cap-72
        # bucket on the wide route): each its plan
        **{f"launches_edge_shapes_{k}": v["kernel_launches"] for k, v in edge["runs"].items()},
        # the wide route at the h384 run's two buckets, one layer-eval:
        # device time, launched from Python, plain version, chain of
        # PyTorch ops, bound and share of it; the same at the cap72 run's
        # cap-72 bucket and, the kernel alone, at h512 and h640 on the h384
        # buckets; errors of all of them
        **{f"wide_{k}": v for k, v in wide.items()},
        **{f"wide_{name}_{k}": v for name, t in wide_more.items() for k, v in t.items()},
        wide_max_abs_err=max([v["kernel_vs_plain"]["max_abs_err_f32"] for v in edge["runs"].values()]
                             + [v["kernel_vs_plain"]["max_abs_err_f32"]
                                for v in edge["runs"]["h384"]["wider"].values()]),
        wide_max_abs_err_bf16=max([v["kernel_vs_plain"]["max_abs_err_bf16"]
                                   for v in edge["runs"].values()]
                                  + [v["kernel_vs_plain"]["max_abs_err_bf16"]
                                     for v in edge["runs"]["h384"]["wider"].values()]),
        # DiffCSP, DDPO and knn edges run the plain net: checked to be 0
        launches_diffcsp_ddpo=[csp["iteration"]["kernel_launches"]] + [
            it["kernel_launches"] for rec in ddpo for it in rec["iterations"]],
        launches_knn=knn["kernel_launches"],
        # the config-driven entry points (> 0, the sampler's plan) and
        # pretraining (the plain net: 0)
        **{f"launches_{k}": v["kernel_launches"] for k, v in entry.items()},
        launches_pretrain=pre["kernel_launches"],
        # the ALIGNN reward's main iteration (the sampler's plan) and each
        # data-parallel rank's sample of its rows (its own plan)
        launches_alignn_main=alignn["main"]["kernel_launches"],
        launches_dp_per_rank=dp["kernel_launches_per_rank"],
        # the distilled student's sample (its plan) and distillation's
        # training (the plain net: 0)
        launches_distill=distilled["kernel_launches"],
        launches_distill_train=distilled["kernel_launches_train"],
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
