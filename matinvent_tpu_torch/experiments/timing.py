"""Kernel times and bounds on the card.

A time is CUDA events around a run of launches after a warm-up; a bound is
the least time the card could take for the same work: the bytes the
function must move (each input read once, each output written once) over
the memory rate, or its operations over the peak rate of their type,
whichever is larger.
"""
from __future__ import annotations

import subprocess

import torch

# published H100 SXM peaks (NVIDIA data sheet, 700 W): memory rate, FP32
# outside the tensor cores, dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, after 3 warm-up
    calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(moved_bytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    """``(ms, "bytes" or "operations")``: the bound and what sets it."""
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def card() -> dict:
    """The card's name, and its name and power limit as nvidia-smi gives
    them (None where nvidia-smi is missing)."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}
