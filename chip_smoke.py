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
* two RL iterations of the ``rl_hhi_rich5`` recipe, built by the entry
  point ``matinvent_tpu_torch.pipeline.mat_invent`` (``resolve``, ``build``)
  and run one ``MatInvent.rl_step`` at a time (phase ``rl``): sample,
  filter, HHI reward, memory and replay, fine-tune; 12,000 kernel launches
  in each iteration's sampling.

Kernel times are device times (CUDA graph replay, ``experiments/timing.py``).
Each phase prints one JSON line (the harnesses print their own records
too); the line before the last is the ``{"kernels": [...]}`` record and the
last line is ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that line. It needs one CUDA card;
without one it exits non-zero at once. It writes the kernel builds
(``matinvent_tpu_torch/_build/``) and, for phase ``rl``, a temporary
directory that it removes.
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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

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
from matinvent_tpu_torch.models.mattergen.sample import MatterGenSampler
from matinvent_tpu_torch.models.suite.mattergen import load_model
from matinvent_tpu_torch.ops.fused_edge import fused_edge_chain, fused_edge_chain_plain
from matinvent_tpu_torch.parallel.train import FinetuneStep
from matinvent_tpu_torch.pipeline import mat_invent

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
# the fine-tune chunk (16 crystals x 25 timesteps, rl_profile.chunk_inputs)
# at grid indices 500..524, the recipe's lr and KL weight
FT_CHUNK, FT_LR, FT_SIGMA = 20, 1e-4, 0.1
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
DEV = "cuda"
BATCH, BUCKETS, MAX_ATOMS, SEED = 256, 4, 20, 0
SOURCES = ("fused_edge", "edge_flat")  # csrc/<name>.cu
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
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        host = pool.submit(build_host, "charge_balance")
        built = dict(zip(SOURCES, pool.map(build, SOURCES)))
        host = host.result()
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
               host_library=str(host.path.relative_to(ROOT)), gxx_seconds=host.seconds)
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


def phase_rl(start_sd: dict) -> dict:
    """Two iterations of the rl_hhi_rich5 recipe, built as the entry point
    builds it and run one ``rl_step`` at a time on the card, into a
    temporary directory: 12,000 kernel launches in each iteration's
    sampling, every fine-tune loss finite, the prior unchanged, the second
    iteration sampling from the updated agent, the JAX run's metrics.csv
    columns, the memory and sample files, and a saved checkpoint equal to
    the agent. The per-iteration values come from the metrics rows and the
    pipeline's log."""
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_rl_")
    iters: list[dict] = []
    root = logging.getLogger()
    level, log = root.level, LogRecords()
    root.setLevel(logging.INFO)
    root.addHandler(log)
    try:
        pipe = mat_invent.build(mat_invent.resolve("rl_hhi_rich5", 2), out)
        c = pipe.agent.config
        expected = c.num_layers * (1 + c.n_corrector) * c.timesteps
        for step in range(pipe.rl_epoch):
            pipe.step = step
            log.messages.clear()
            at_start = all(torch.equal(v.cpu(), start_sd[k])
                           for k, v in pipe.agent.state_dict().items())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fused_edge_chain.launches = 0
            pipe.rl_step()
            torch.cuda.synchronize()
            launches = fused_edge_chain.launches
            row = pipe.logger.rows[-1]
            losses = log.numbers(r"loss\w*: (\S+?)(?:,|$)")
            iters.append(dict(
                step=step, kernel_launches=launches, agent_is_start_checkpoint=at_start,
                valid=int(log.numbers(r"Number of valid samples: (\d+)")[0]),
                reward_mean=row.get("reward mean"),
                finetune_batch=int(log.numbers(r"Fine-tune batch: (\d+)")[0]),
                finetune_losses=losses,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                **{k: row.get(k) for k in ("time_sample_s", "time_score_s", "time_finetune_s")},
            ))
            if launches != expected:
                raise AssertionError(f"iteration {step}: {launches} launches, not {expected}")
            if len(losses) != 3 * pipe.finetuner.epochs or not all(map(math.isfinite, losses)):
                raise AssertionError(f"iteration {step}: fine-tune losses {losses}")
        if [it["agent_is_start_checkpoint"] for it in iters] != [True, False]:
            raise AssertionError("the second iteration did not sample from the updated agent")
        if any(not torch.equal(v.cpu(), start_sd[k]) for k, v in pipe.prior.state_dict().items()):
            raise AssertionError("the prior changed")
        with open(Path(out) / "metrics.csv") as fh, open(RL_METRICS) as ref:
            header, ref_header = fh.readline().strip(), ref.readline().strip()
        if header != ref_header:
            raise AssertionError(f"metrics.csv columns {header} != {ref_header}")
        for name in ("long_term_memory.csv", "step_0000_eval.extxyz", "step_0001_eval.extxyz"):
            if not (Path(out) / "samples" / name).is_file():
                raise AssertionError(f"{name} was not written")
        pipe.model_suite.save_model(pipe.agent, Path(out) / "models/final")
        final = load_model(Path(out) / "models/final", device=DEV)
        if any(not torch.equal(v, pipe.agent.state_dict()[k]) for k, v in final.state_dict().items()):
            raise AssertionError("the final checkpoint differs from the agent")
    finally:
        root.removeHandler(log)
        root.setLevel(level)
        shutil.rmtree(out, ignore_errors=True)
    rec = dict(phase="rl", recipe="rl_hhi_rich5", iterations=iters,
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
    valid = phase_validity(model)
    del model
    rl = phase_rl(start_sd)
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
