"""Kernel times and bounds on the card.

A time is CUDA events around a replay of a CUDA graph that holds a run of
calls, captured after a warm-up: the device time per call, without the
host's enqueue between launches (``time_ms``). ``eager_ms`` times the same
calls launched one by one from Python, which is what a caller that does
not capture them pays when the host is slower than the device. A bound is
the least time the card could take for the same work: the bytes the
function must move (each input read once, each output written once) over
the memory rate, or its operations over the peak rate of the route that
computes them, whichever is larger.
"""
from __future__ import annotations

import subprocess

import torch

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): memory rate,
# and per compute dtype the rate of the route the kernels take for the
# products: bf16 on the tensor cores; f32 as 3xTF32 on the tensor cores,
# three TF32 products (495 TFLOP/s) for each f32 one
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
PEAK_ROUTE = {
    torch.float32: "3xTF32 tensor cores (495 TFLOP/s / 3)",
    torch.bfloat16: "bf16 tensor cores (989 TFLOP/s)",
}


def time_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()``: ``iters`` calls captured in one
    CUDA graph (after 3 warm-up calls), replayed once under CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # the first replay uploads the graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` launched ``iters`` times from Python on
    the current stream, after 3 warm-up calls (CUDA events)."""
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
