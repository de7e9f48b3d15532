"""Ablation harness of the fused edge kernel on the card (the port of
``experiments/fused_edge_ab_r5.py``).

    python -m matinvent_tpu_torch.experiments.fused_edge_ab

It times the sampler's edge kernel (``csrc/fused_edge.cu``) at the dominant
bucket of ``bench.py``'s operating point (203 crystals at cap 20: 81,200
edge rows, H = 256, bf16), with parts of the kernel switched off at compile
time, to attribute its time:

  full       the sampler's kernel (the same instance ``fused_edge_chain``
             launches)
  nosin      raw phases in place of sin/cos (the transcendentals)
  nobcast    no ``t_i + t_j`` broadcast add, and the j-slice below
  noagg      ``s[:, :, 0] * u_i`` in place of the masked j-sum
  gemmonly   all three removed: GEMM -> silu -> GEMM -> silu

Each mode's kernel is timed beside its plain version, and ``torch_chain``,
the same function as a chain of PyTorch ops (cuBLAS products), is timed as
the baseline. Times are CUDA events over a captured CUDA graph of launches
(device time, ``experiments/timing.py``); the TPU harness's block-size
sweep has no counterpart, since the CUDA kernel keeps its own geometry,
which the record states. Prints one JSON record.
"""
from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F

from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.experiments.timing import bound_ms, card, eager_ms, nbytes, time_ms
from matinvent_tpu_torch.models.cspnet import sinusoids_embedding
from matinvent_tpu_torch.ops.fused_edge import (
    check_tensors,
    edge_chain_plain,
    launch_edge_kernel,
    phase_consts,
    phase_embedding,
    round_up,
)

H, NF, DP = 256, 10, 64
CDT = torch.bfloat16
ABLATIONS = ("full", "nosin", "nobcast", "noagg", "gemmonly")
# mode -> (sin/cos, t_i + t_j, j-sum); the j-slice keeps row j = 0
_PARTS = {
    "full": (True, True, True),
    "nosin": (False, True, True),
    "nobcast": (True, False, False),
    "noagg": (True, True, False),
    "gemmonly": (False, False, False),
}
ROWS_PER_TILE = 64  # edge rows of one CUDA tile (csrc/edge_tiles.cuh kRows)


def edge_variant_plain(mode, ti, tj, fr, ui, uj, fmat, wd, w1, b1):
    """Plain PyTorch version of ``experiments/fused_edge_ab_r5.py:47
    _kernel_variant``: ``ti, tj [B, A, H]``, ``fr [B, A, 3]`` f32,
    ``ui, uj [B, A, 1]`` f32, ``fmat [3, lanes]`` f32, ``wd [lanes, H]``,
    ``w1 [H, H]``, ``b1 [1, H]``; lanes below ``3 NF`` take sin, the others
    cos, and all ``lanes`` lanes are live (lanes past ``6 NF`` carry
    ``cos(0) = 1``)."""
    sincos, bcast, agg = _PARTS[mode]
    emb = phase_embedding(fr, fmat, 3 * NF, sincos=sincos)
    return edge_chain_plain(ti, tj, emb, ui, uj, wd, w1, b1, bcast=bcast, agg=agg)


def edge_variant(mode, ti, tj, fr, ui, uj, fmat, wd, w1, b1):
    """``edge_variant_plain``'s function; on CUDA tensors it launches
    ``csrc/fused_edge.cu`` in ``mode`` (bf16, H = 256 only) and counts the
    launch in ``edge_variant.launches``."""
    if mode not in _PARTS:
        raise ValueError(f"mode must be one of {ABLATIONS}, got {mode!r}")
    if ti.device.type == "cpu":
        return edge_variant_plain(mode, ti, tj, fr, ui, uj, fmat, wd, w1, b1)
    B, A, _ = ti.shape
    lanes = wd.shape[0]
    if not (1 <= A <= ROWS_PER_TILE and 3 * NF <= lanes <= DP):
        raise ValueError(f"atoms {A} must be in 1..64, lanes {lanes} in {3 * NF}..{DP}")
    check_tensors([
        ("ti", ti, (B, A, H), CDT), ("tj", tj, (B, A, H), CDT),
        ("fr", fr, (B, A, 3), torch.float32),
        ("ui", ui, (B, A, 1), torch.float32), ("uj", uj, (B, A, 1), torch.float32),
        ("fmat", fmat, (3, lanes), torch.float32), ("wd", wd, (lanes, H), CDT),
        ("w1", w1, (H, H), CDT), ("b1", b1, (1, H), CDT),
    ], ti.device)
    out = launch_edge_kernel(mode, ti, tj, fr, fmat, None, ui, uj, wd, w1, b1,
                             n_sin=3 * NF)
    edge_variant.launches += 1
    return out


edge_variant.launches = 0


def chain_silu(x):
    """``jax.nn.silu``'s definition, ``x * sigmoid(x)``, op by op in the
    dtype of ``x`` (the chains' silu)."""
    return x * torch.sigmoid(x)


def chain_from_emb(ti, tj, dist, ui, uj, wd, w1, b1):
    """The edge chain from a ``[B, A, A, lanes]`` embedding on, as PyTorch
    ops in the compute dtype (that of ``ti``): two einsums (cuBLAS), the
    broadcast add, silu and the masked j-sum, each materialized."""
    cdt = ti.dtype
    e = torch.einsum("bijd,dh->bijh", dist, wd) + (
        ti[:, :, None, :] + tj[:, None, :, :]
    ).to(cdt)
    e = chain_silu(e)
    s = chain_silu(torch.einsum("bijh,hk->bijk", e, w1) + b1.to(cdt))
    agg = torch.sum(s * uj[:, None, :, :].to(cdt), dim=2)
    return (agg * ui).to(cdt)


def torch_chain(ti, tj, fr, ui, uj, fmat, wd, w1, b1):
    """Counterpart of ``experiments/fused_edge_ab_r5.py:122 xla_chain``: the
    fc edge chain with the embedding recomputed, zero-padded to ``DP``
    lanes (``fmat`` is not read: the chain has its own frequencies)."""
    fd = (fr[:, None, :, :] - fr[:, :, None, :]) % 1.0
    dist = sinusoids_embedding(fd, NF).to(CDT)
    dist = F.pad(dist, (0, DP - 6 * NF))
    return chain_from_emb(ti, tj, dist, ui, uj, wd, w1, b1)


def make_inputs(rng: np.random.Generator, crystals: int, atoms: int, device):
    """The harness's inputs, drawn in the order of
    ``experiments/fused_edge_ab_r5.py:177-191``; returns the argument tuple
    of ``edge_variant`` (after the mode) and the atom counts."""
    Bb, Ab = crystals, atoms
    ti = rng.normal(size=(Bb, Ab, H)) * 0.1
    tj = rng.normal(size=(Bb, Ab, H)) * 0.1
    fr = rng.uniform(size=(Bb, Ab, 3))
    na = rng.integers(1, Ab + 1, (Bb,))
    mask = (np.arange(Ab)[None, :] < na[:, None]).astype(np.float32)
    ui = (mask / np.maximum(na[:, None], 1))[..., None]
    uj = mask[..., None]
    fmat = phase_consts(NF, DP)
    wd = rng.normal(size=(DP, H)) * 0.05
    w1 = rng.normal(size=(H, H)) * 0.05
    b1 = rng.normal(size=(1, H)) * 0.05

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=torch.float32).to(device=device, dtype=dtype)

    args = (t(ti, CDT), t(tj, CDT), t(fr), t(ui), t(uj), t(fmat), t(wd, CDT),
            t(w1, CDT), t(b1, CDT))
    return args, na


def pair_work(na: np.ndarray, lanes: int, args) -> dict:
    """Flops of one 4-D edge call on the real atom pairs (``na`` atoms per
    crystal, ``lanes`` embedding lanes), bytes of its inputs ``args`` and
    of its ``[B, A, H]`` output, and the bound they set."""
    pairs = int((na.astype(np.int64) ** 2).sum())
    flops = 2.0 * pairs * (lanes * H + H * H)
    moved = nbytes(*args) + nbytes(args[0])  # the output is shaped as term_i
    ms, by = bound_ms(moved, flops, CDT)
    return dict(pairs=pairs, flops=flops, bytes=moved, bound_ms=ms, bound_by=by)


def persistent_blocks(tiles: int) -> int | None:
    """Blocks of a persistent launch over ``tiles`` tiles at one block per
    SM (None without a card)."""
    if not torch.cuda.is_available():
        return None
    return min(tiles, torch.cuda.get_device_properties(0).multi_processor_count)


def geometry(crystals: int, atoms: int) -> dict:
    """The CUDA kernel's launch: 64-row tiles of ``rows_i`` whole rows i each,
    packed across crystals, walked by persistent blocks of 256 threads (one
    per SM at H = 256, where a block holds 200 KB of shared memory)."""
    rows_i = ROWS_PER_TILE // atoms
    tiles = round_up(crystals * atoms, rows_i) // rows_i
    return dict(threads=256, rows_i_per_tile=rows_i, edge_rows_per_tile=rows_i * atoms,
                tiles=tiles, blocks=persistent_blocks(tiles), blocks_per_sm=1)


def main(device=None, crystals: int = 203, atoms: int = 20, iters: int = 50) -> dict:
    """Run the ablation at ``crystals`` crystals of cap ``atoms`` and print
    one JSON record. On the CPU (``device="cpu"``) the kernels' plain
    versions run and no time is measured (the times are null)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    args, na = make_inputs(np.random.default_rng(0), crystals, atoms, dev)

    def timed(fn, clock=time_ms):
        return clock(fn, iters) if on_card else None

    rec = dict(harness="fused_edge_ab", device=card() if on_card else "cpu",
               crystals=crystals, atoms=atoms, H=H, lanes=DP, dtype="bfloat16",
               edge_rows=crystals * atoms * atoms, iters=iters,
               geometry=geometry(crystals, atoms), **pair_work(na, DP, args))
    modes = {}
    for mode in ABLATIONS:
        out = edge_variant(mode, *args)
        ref = edge_variant_plain(mode, *args)
        modes[mode] = dict(
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            ms=timed(lambda: edge_variant(mode, *args)),
            eager_ms=timed(lambda: edge_variant(mode, *args), eager_ms),
            plain_ms=timed(lambda: edge_variant_plain(mode, *args)),
        )
    rec["modes"] = modes
    rec["torch_chain_ms"] = timed(lambda: torch_chain(*args))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
