"""Flat-form harness of the fused edge kernel on the card (the port of
``experiments/fused_edge_flat_r5.py``).

    python -m matinvent_tpu_torch.experiments.fused_edge_flat

Two questions about the sampler's edge kernel, at the dominant bucket of
``bench.py``'s operating point (203 crystals at cap 20: 81,200 edge rows,
H = 256, bf16):

  flat   can the flattened form beat the 4-D fused form? ``flat_edge_mlp``
         (``csrc/edge_flat.cu``) runs GEMM -> silu -> GEMM -> silu over
         ``[rows, .]`` operands (``emb [R, 64]``, ``ts [R, 256]``) and
         leaves the aggregation out; ``torch_flat_chain`` is the same
         sub-chain as PyTorch ops (cuBLAS products).
  demb   what does the in-kernel embedding cost? ``demb_edge`` is the
         sampler's kernel (``csrc/fused_edge.cu``) reading a precomputed
         ``[B, A, A, 64]`` embedding instead of computing sin/cos;
         ``torch_demb_chain`` is its chain of PyTorch ops.

Each kernel is timed beside its plain version with CUDA events over a
captured CUDA graph of launches (``experiments/timing.py``); the TPU
harness's block-size sweep has no counterpart. Prints one JSON record.
"""
from __future__ import annotations

import ctypes
import functools
import json

import numpy as np
import torch

from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.experiments.fused_edge_ab import (
    CDT,
    DP,
    H,
    ROWS_PER_TILE,
    chain_silu,
    chain_from_emb,
    geometry,
    pair_work,
    persistent_blocks,
)
from matinvent_tpu_torch.experiments.timing import bound_ms, card, eager_ms, nbytes, time_ms
from matinvent_tpu_torch.ops.fused_edge import (
    check_tensors,
    edge_chain_plain,
    launch_edge_kernel,
    round_up,
)


def flat_edge_mlp_plain(ts, emb, wd, w1, b1):
    """Plain PyTorch version of ``experiments/fused_edge_flat_r5.py:41
    _flat_kernel``: ``silu(silu(emb @ w_d + ts) @ w_1 + b_1)`` over rows,
    products in f32 on compute-dtype operands, ``e`` rounded to the
    compute dtype before the second product."""
    cdt, f32 = ts.dtype, torch.float32
    e = torch.nn.functional.silu(emb.to(f32) @ wd.to(f32) + ts.to(f32))
    s = e.to(cdt).to(f32) @ w1.to(f32) + b1.to(f32).reshape(-1)
    return torch.nn.functional.silu(s).to(cdt)


@functools.cache
def _flat_launch_fn():
    from matinvent_tpu_torch.csrc.build import build

    fn = build("edge_flat").lib.edge_flat_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flat_edge_mlp(ts, emb, wd, w1, b1):
    """``flat_edge_mlp_plain``'s function; on CUDA tensors it launches
    ``csrc/edge_flat.cu`` (bf16, H = 256) and counts the launch in
    ``flat_edge_mlp.launches``. ``ts [R, H]``, ``emb [R, lanes]``,
    ``wd [lanes, H]``, ``w1 [H, H]``, ``b1 [1, H]``."""
    if ts.device.type == "cpu":
        return flat_edge_mlp_plain(ts, emb, wd, w1, b1)
    R, lanes = emb.shape[0], wd.shape[0]
    if not (R >= 1 and 1 <= lanes <= DP):
        raise ValueError(f"rows {R} must be >= 1, lanes {lanes} in 1..{DP}")
    check_tensors([
        ("ts", ts, (R, H), CDT), ("emb", emb, (R, lanes), CDT),
        ("wd", wd, (lanes, H), CDT), ("w1", w1, (H, H), CDT), ("b1", b1, (1, H), CDT),
    ], ts.device)
    out = torch.empty_like(ts)
    err = _flat_launch_fn()(
        emb.data_ptr(), ts.data_ptr(), wd.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        out.data_ptr(), R, lanes, H, 1, torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"edge_flat_launch failed: cudaError {err}")
    flat_edge_mlp.launches += 1
    return out


flat_edge_mlp.launches = 0


def torch_flat_chain(ts, emb, wd, w1, b1):
    """Counterpart of ``experiments/fused_edge_flat_r5.py:78 flat_xla``."""
    e = chain_silu(emb @ wd + ts)
    return chain_silu(e @ w1 + b1).to(CDT)


def demb_edge_plain(ti, tj, de, ui, uj, wd, w1, b1):
    """Plain PyTorch version of ``experiments/fused_edge_flat_r5.py:83
    _demb_kernel``: the fused edge chain on a precomputed embedding
    ``de [B, A, A, lanes]``."""
    return edge_chain_plain(ti, tj, de, ui, uj, wd, w1, b1)


def demb_edge(ti, tj, de, ui, uj, wd, w1, b1):
    """``demb_edge_plain``'s function; on CUDA tensors it launches
    ``csrc/fused_edge.cu`` in mode ``demb`` (bf16, H = 256) and counts the
    launch in ``demb_edge.launches``."""
    if ti.device.type == "cpu":
        return demb_edge_plain(ti, tj, de, ui, uj, wd, w1, b1)
    B, A, _ = ti.shape
    lanes = wd.shape[0]
    if not (1 <= A <= ROWS_PER_TILE and 1 <= lanes <= DP):
        raise ValueError(f"atoms {A} must be in 1..64, lanes {lanes} in 1..{DP}")
    check_tensors([
        ("ti", ti, (B, A, H), CDT), ("tj", tj, (B, A, H), CDT),
        ("de", de, (B, A, A, lanes), CDT),
        ("ui", ui, (B, A, 1), torch.float32), ("uj", uj, (B, A, 1), torch.float32),
        ("wd", wd, (lanes, H), CDT), ("w1", w1, (H, H), CDT), ("b1", b1, (1, H), CDT),
    ], ti.device)
    out = launch_edge_kernel("demb", ti, tj, None, None, de, ui, uj, wd, w1, b1, n_sin=0)
    demb_edge.launches += 1
    return out


demb_edge.launches = 0


def torch_demb_chain(ti, tj, de, ui, uj, wd, w1, b1):
    """``demb_edge``'s function as a chain of PyTorch ops."""
    return chain_from_emb(ti, tj, de, ui, uj, wd, w1, b1)


def make_inputs(rng: np.random.Generator, crystals: int, atoms: int, device):
    """The harness's inputs, drawn in the order of
    ``experiments/fused_edge_flat_r5.py:170-199`` with ``R = crystals *
    atoms^2`` rows; returns the argument tuples of ``flat_edge_mlp`` and
    ``demb_edge`` and the atom counts."""
    R, Bb, Ab = crystals * atoms * atoms, crystals, atoms
    ts = rng.normal(size=(R, H)) * 0.1
    emb = rng.normal(size=(R, DP)) * 0.5
    wd = rng.normal(size=(DP, H)) * 0.05
    w1 = rng.normal(size=(H, H)) * 0.05
    b1 = rng.normal(size=(1, H)) * 0.05
    ti = rng.normal(size=(Bb, Ab, H)) * 0.1
    tj = rng.normal(size=(Bb, Ab, H)) * 0.1
    de = rng.normal(size=(Bb, Ab, Ab, DP)) * 0.5
    na = rng.integers(1, Ab + 1, (Bb,))
    mask = (np.arange(Ab)[None, :] < na[:, None]).astype(np.float32)
    ui = (mask / np.maximum(na[:, None], 1))[..., None]
    uj = mask[..., None]

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=torch.float32).to(device=device, dtype=dtype)

    wd, w1, b1 = t(wd, CDT), t(w1, CDT), t(b1, CDT)
    flat = (t(ts, CDT), t(emb, CDT), wd, w1, b1)
    demb = (t(ti, CDT), t(tj, CDT), t(de, CDT), t(ui), t(uj), wd, w1, b1)
    return flat, demb, na


def flat_work(args) -> dict:
    """Flops and bytes of one ``flat_edge_mlp`` call, and their bound."""
    R, lanes = args[1].shape
    flops = 2.0 * R * (lanes * H + H * H)
    moved = nbytes(*args) + nbytes(args[0])
    ms, by = bound_ms(moved, flops, CDT)
    return dict(flops=flops, bytes=moved, bound_ms=ms, bound_by=by)


def main(device=None, crystals: int = 203, atoms: int = 20, iters: int = 50) -> dict:
    """Run both forms at ``crystals`` crystals of cap ``atoms`` and print one
    JSON record. On the CPU (``device="cpu"``) the kernels' plain versions
    run and no time is measured (the times are null)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    flat, demb, na = make_inputs(np.random.default_rng(0), crystals, atoms, dev)

    def timed(fn, clock=time_ms):
        return clock(fn, iters) if on_card else None

    def err(out, ref):
        return (out.float() - ref.float()).abs().max().item()

    R = flat[0].shape[0]
    tiles = round_up(R, ROWS_PER_TILE) // ROWS_PER_TILE
    rec = dict(harness="fused_edge_flat", device=card() if on_card else "cpu",
               crystals=crystals, atoms=atoms, R=R, H=H, lanes=DP, dtype="bfloat16",
               iters=iters)
    rec["flat"] = dict(
        max_abs_err=err(flat_edge_mlp(*flat), flat_edge_mlp_plain(*flat)),
        ms=timed(lambda: flat_edge_mlp(*flat)),
        eager_ms=timed(lambda: flat_edge_mlp(*flat), eager_ms),
        plain_ms=timed(lambda: flat_edge_mlp_plain(*flat)),
        torch_chain_ms=timed(lambda: torch_flat_chain(*flat)),
        geometry=dict(threads=256, rows_per_tile=ROWS_PER_TILE, tiles=tiles,
                      blocks=persistent_blocks(tiles), blocks_per_sm=1),
        **flat_work(flat),
    )
    rec["demb"] = dict(
        max_abs_err=err(demb_edge(*demb), demb_edge_plain(*demb)),
        ms=timed(lambda: demb_edge(*demb)),
        eager_ms=timed(lambda: demb_edge(*demb), eager_ms),
        plain_ms=timed(lambda: demb_edge_plain(*demb)),
        torch_chain_ms=timed(lambda: torch_demb_chain(*demb)),
        geometry=geometry(crystals, atoms),
        **pair_work(na, DP, demb),
    )
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
