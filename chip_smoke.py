"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``matinvent_tpu_torch/csrc`` with
``nvcc``, holds it against its plain PyTorch version, runs the full-width
``rl_hhi_rich5`` score net through both edge paths, and samples 256 crystals
at T=1000 through the user entry point (``MatterGenSampler`` ->
``MatterGenDiffusion.sample_bucketed``), counting the kernel's launches.
Each phase prints one JSON line; the line before the last is the
``{"kernels": [...]}`` record and the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line. It needs one CUDA card; without one it
exits non-zero at once. It writes nothing but the kernel build
(``matinvent_tpu_torch/_build/``).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from matinvent_tpu_torch.chem.validity import structure_validity
from matinvent_tpu_torch.csrc.build import build
from matinvent_tpu_torch.models.mattergen.diffusion import MGNoised
from matinvent_tpu_torch.models.mattergen.sample import MatterGenSampler
from matinvent_tpu_torch.models.suite.mattergen import load_model
from matinvent_tpu_torch.ops.fused_edge import fused_edge_chain, fused_edge_chain_plain

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "experiments/results/rl_hhi_rich5/models/final"
DEV = "cuda"
BATCH, BUCKETS, MAX_ATOMS, SEED = 256, 4, 20, 0
# published H100 SXM peaks (NVIDIA data sheet, 700 W): memory rate, FP32
# outside the tensor cores, dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
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
    dtype = args[0].dtype
    out = fused_edge_chain(*args, num_freqs=nf)
    torch.cuda.synchronize()
    ref = fused_edge_chain_plain(*args, num_freqs=nf)
    if not torch.isfinite(out.float()).all():
        raise AssertionError("kernel output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype] * max(1.0, ref.float().abs().max().item())
    shape = tuple(args[0].shape)
    if err > tol:
        raise AssertionError(f"kernel vs plain {shape} {dtype}: {err} > {tol}")
    if (out[~mask] != 0).any():
        raise AssertionError(f"padded rows not exactly 0 {shape} {dtype}")
    return err


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(args, num_atoms, nf: int) -> tuple[float, str]:
    """Least time (ms) for one call: bytes of the inputs read once and the
    output written once over the memory rate, against the flops the real
    (i, j) pairs need over the dtype's peak; whichever is larger."""
    dtype = args[0].dtype
    H = args[0].shape[-1]
    nbytes = sum(a.numel() * a.element_size() for a in args) + args[0].numel() * args[0].element_size()
    pairs = float((num_atoms.to(torch.float64) ** 2).sum().item())
    flops = 2.0 * pairs * (6 * nf * H + H * H)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


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


def phase_build() -> dict:
    t0 = time.perf_counter()
    built = build("fused_edge")
    report = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    rec = dict(
        phase="build", library=str(built.path.relative_to(ROOT)),
        nvcc_seconds=built.seconds, seconds=time.perf_counter() - t0, ptxas=report,
    )
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
            row[f"{tag}_plain_ms"] = time_ms(
                lambda: fused_edge_chain_plain(*args, num_freqs=nf), 10
            )
            row[f"{tag}_bound_ms"], row[f"{tag}_bound_by"] = bound(args, num_atoms, nf)
        buckets.append(row)
    rec = dict(
        phase="kernel", max_abs_err_f32=errs[torch.float32],
        max_abs_err_bf16=errs[torch.bfloat16], tol_f32=TOL[torch.float32],
        tol_bf16=TOL[torch.bfloat16], buckets=buckets,
        seconds=time.perf_counter() - t0,
    )
    emit(rec)
    return rec


def phase_score_net(model) -> dict:
    """Full-width net, kernel edge path against plain edge path, f32."""
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
        fused = model.apply_net(noised, na, mask, fused_edge=True)
        plain = model.apply_net(noised, na, mask, fused_edge=False)
    torch.cuda.synchronize()
    errs = {k: (fused[k] - plain[k]).abs().max().item() for k in fused}
    for k, v in fused.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"score net output {k} is not finite")
    if max(errs.values()) > 2e-4:
        raise AssertionError(f"fused vs plain score net: {errs} > 2e-4")
    rec = dict(phase="score_net", batch=B, max_atoms=A, max_abs_err=errs, atol=2e-4,
               seconds=time.perf_counter() - t0)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device()
    phase_build()
    kern = phase_kernel()
    model = load_model(CKPT, device=DEV)
    phase_score_net(model)
    samp = phase_sampling(model)
    b = kern["buckets"]
    emit({"kernels": [dict(
        name="fused_edge_chain", route="cuda", impl="cuda", checked=True,
        source="matinvent_tpu_torch/csrc/fused_edge.cu",
        replaces="matinvent_tpu/ops/fused_edge.py:73",
        launches=samp["kernel_launches"],
        max_abs_err=kern["max_abs_err_f32"],
        max_abs_err_bf16=kern["max_abs_err_bf16"],
        # one layer-eval of the batch: the sum over the bucket shapes, f32
        ms=sum(r["f32_ms"] for r in b),
        plain_ms=sum(r["f32_plain_ms"] for r in b),
        bound_ms=sum(r["f32_bound_ms"] for r in b),
        bound_by=b[-1]["f32_bound_by"],
        # no single PyTorch call computes this chain
        library_ms=None,
        bf16_ms=sum(r["bf16_ms"] for r in b),
        bf16_bound_ms=sum(r["bf16_bound_ms"] for r in b),
    )]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"], "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
