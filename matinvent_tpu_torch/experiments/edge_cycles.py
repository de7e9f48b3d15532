"""Where the fused edge kernel's time goes, phase by phase, on the card.

    python -m matinvent_tpu_torch.experiments.edge_cycles [--csrc DIR]

Builds ``csrc/fused_edge.cu`` a second time with ``-DFUSED_EDGE_CYCLES``,
which closes each phase of the kernel's tile (or chunk) loop with a barrier
and adds block 0's clock cycles per phase to counters on the card.

* the tiled instances at the harness shape of ``fused_edge_ab``
  (203 crystals at cap 20, H = 256, 64 lanes), mode ``full`` and
  ``gemmonly`` in bf16 and mode ``full`` in f32, per tile of block 0.
* the wide route at the buckets of ``chip_smoke.py``'s phase
  ``edge_shapes`` that it runs (``EDGE_SHAPES_RUNS``: the h384 model's two
  buckets, the cap-72 bucket at h256), both dtypes: block 0's cycles per
  phase summed over its chunks and the buckets, and each phase's share;
  beside them the device time of one call per bucket of the build without
  the counters (CUDA-graph replay, ``experiments/timing.py``).

``--csrc DIR`` builds ``DIR/fused_edge.cu`` instead (with the
``edge_tiles.cuh`` beside it), to split an earlier version of the kernel
in the same call; it must have the same C interface and the same eight
counters. Prints one JSON record. The extra barriers cost a little, so the
phases add up to slightly more than the uninstrumented kernel's time; their
shares are what the record is for.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import numpy as np
import torch

from matinvent_tpu_torch.csrc.build import CSRC, build
from matinvent_tpu_torch.experiments.fused_edge_ab import (
    NF,
    ROWS_PER_TILE,
    make_inputs,
    persistent_blocks,
)
from matinvent_tpu_torch.experiments.timing import card, time_ms
from matinvent_tpu_torch.models.mattergen.sample import (
    MatterGenSampler,
    register_num_atoms_distribution,
)
from matinvent_tpu_torch.ops.fused_edge import MODES, phase_consts, tiled

PHASES = ("prep", "rows", "emb", "gemm1", "epilogue1", "gemm2", "silu2", "jsum")
# phase edge_shapes of chip_smoke.py: MatterGen samplers whose buckets the
# tiled instances do not all take: (name, hidden, max_atoms, crystals,
# buckets, histogram over atom counts), drawn with EDGE_SHAPES_SEED
EDGE_SHAPES_SEED = 4
EDGE_SHAPES_RUNS = [
    ("h384", 384, 20, 32, 2, {4: 1.0, 6: 1.0, 8: 1.0, 12: 1.0, 16: 1.0, 20: 1.0}),
    ("cap72", 256, 72, 32, 3, {**{n: 1.0 for n in range(4, 13)}, **{n: 1.0 for n in range(30, 41)},
                               **{n: 1.0 for n in range(66, 73)}}),
]


def edge_shapes_plans(name: str) -> tuple[int, list[tuple[np.ndarray, int]]]:
    """``(hidden, [(atom counts, cap), ...])``: the buckets of the
    ``EDGE_SHAPES_RUNS`` sampler ``name``, as its bucketed launch cuts them."""
    _, hidden, max_atoms, n, buckets, hist = next(r for r in EDGE_SHAPES_RUNS if r[0] == name)
    register_num_atoms_distribution(f"edge_shapes_{name}", hist)
    sampler = MatterGenSampler(batch_size=n, num_batches=1, max_atoms=max_atoms,
                               num_atoms_distribution=f"edge_shapes_{name}",
                               size_buckets=buckets, seed=EDGE_SHAPES_SEED)
    na = sampler._draw_num_atoms(n)
    cuts, caps = sampler.bucket_plan(na)
    return hidden, [(np.minimum(na[idx], cap), cap) for idx, cap in zip(cuts, caps)]


def _bind(lib):
    launch = lib.fused_edge_launch
    launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return launch


def _caller(launch, mode, args, out, B, A, H, lanes, dtype):
    ti, tj, fr, ui, uj, fmat, wd, w1, b1 = args
    call = (MODES.index(mode), ti.data_ptr(), tj.data_ptr(), fr.data_ptr(), fmat.data_ptr(),
            None, ui.data_ptr(), uj.data_ptr(), wd.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            out.data_ptr(), B, A, H, lanes, 3 * NF, 0, int(dtype == torch.bfloat16))

    def run():
        if launch(*call, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError(f"fused_edge_launch ({mode}) failed")

    return run


def _cycles(lib, run) -> list[int]:
    """Block 0's counters of the second of two launches of ``run``."""
    read = lib.fused_edge_read_cycles
    read.argtypes = [ctypes.c_void_p]
    counters = (ctypes.c_ulonglong * 8)()
    for _ in range(2):
        run()
        torch.cuda.synchronize()
        if read(ctypes.addressof(counters)) != 0:
            raise RuntimeError("fused_edge_read_cycles failed")
    return [int(c) for c in counters]


def tiled_runs(lib, crystals: int = 203, atoms: int = 20) -> dict:
    args, _ = make_inputs(np.random.default_rng(0), crystals, atoms, "cuda")
    rows_i = ROWS_PER_TILE // atoms
    tiles = -(-crystals * atoms // rows_i)
    blocks = persistent_blocks(tiles)
    per_block = -(-tiles // blocks)  # tiles of block 0
    launch = _bind(lib)

    def run(mode, dtype):
        ti, tj, fr, ui, uj, fmat, wd, w1, b1 = args
        cast = [t.to(dtype).contiguous() for t in (ti, tj, wd, w1, b1.reshape(-1))]
        typed = (cast[0], cast[1], fr, ui, uj, fmat, cast[2], cast[3], cast[4])
        out = torch.empty_like(cast[0])
        cycles = _cycles(lib, _caller(launch, mode, typed, out, crystals, atoms,
                                      cast[0].shape[-1], wd.shape[0], dtype))
        per_tile = {p: c / (1 if p == "prep" else per_block) for p, c in zip(PHASES, cycles)}
        return dict(mode=mode, dtype=str(dtype).split(".")[-1], total_cycles=sum(cycles),
                    cycles_per_tile=per_tile)

    return dict(crystals=crystals, atoms=atoms, tiles=tiles, blocks=blocks,
                tiles_of_block0=per_block,
                runs=[run("full", torch.bfloat16), run("gemmonly", torch.bfloat16),
                      run("full", torch.float32)])


def wide_inputs(na: np.ndarray, cap: int, H: int, dtype, seed: int):
    """Random inputs of one bucket, drawn with numpy (the same for every
    build), on the card: the argument order of ``tiled_runs``' calls."""
    rng = np.random.default_rng(seed)
    B = len(na)
    mask = (np.arange(cap)[None, :] < na[:, None]).astype(np.float32)

    def t(x, dt=torch.float32):
        return torch.tensor(np.asarray(x), dtype=torch.float32).to(device="cuda", dtype=dt)

    return (t(rng.normal(size=(B, cap, H)), dtype), t(rng.normal(size=(B, cap, H)), dtype),
            t(rng.uniform(size=(B, cap, 3))), t((mask / na[:, None])[..., None]),
            t(mask[..., None]), t(phase_consts(NF, 6 * NF)),
            t(rng.normal(size=(6 * NF, H)) * 0.1, dtype), t(rng.normal(size=(H, H)) * 0.1, dtype),
            t(rng.normal(size=(H,)) * 0.1, dtype))


def wide_runs(lib, timed_lib) -> list[dict]:
    launch, timed = _bind(lib), _bind(timed_lib)
    rows_fn = getattr(timed_lib, "fused_edge_wide_rows", None)
    out = []
    for name, _, _, _, _, _ in EDGE_SHAPES_RUNS:
        hidden, plans = edge_shapes_plans(name)
        plans = [(na, cap) for na, cap in plans if not tiled(hidden, cap, 6 * NF)]
        for dtype in (torch.float32, torch.bfloat16):
            cycles, ms = [0] * len(PHASES), 0.0
            for k, (na, cap) in enumerate(plans):
                args = wide_inputs(na, cap, hidden, dtype, seed=k)
                res = torch.empty_like(args[0])
                for i, c in enumerate(_cycles(lib, _caller(launch, "full", args, res, len(na),
                                                           cap, hidden, 6 * NF, dtype))):
                    cycles[i] += c
                ms += time_ms(_caller(timed, "full", args, res, len(na), cap, hidden, 6 * NF,
                                      dtype), 50)
            total = sum(cycles)
            rows = None
            if rows_fn is not None:
                rows_fn.argtypes = [ctypes.c_int] * 3
                rows = rows_fn(hidden, 6 * NF, int(dtype == torch.bfloat16))
            out.append(dict(
                shape=name, hidden=hidden, buckets=[[len(na), cap] for na, cap in plans],
                dtype=str(dtype).split(".")[-1], chunk_rows=rows, ms=ms,
                block0_cycles=dict(zip(PHASES, cycles)), block0_total_cycles=total,
                share={p: c / total for p, c in zip(PHASES, cycles)}))
    return out


def main(csrc: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("edge_cycles measures on a CUDA card")
    src = Path(csrc) if csrc else CSRC
    lib = build("fused_edge", ("FUSED_EDGE_CYCLES",), csrc=src).lib
    rec = dict(script="edge_cycles", device=card(), csrc=str(csrc or "matinvent_tpu_torch/csrc"),
               tiled=tiled_runs(lib), wide=wide_runs(lib, build("fused_edge", csrc=src).lib))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=None, help="directory of another copy of fused_edge.cu")
    main(ap.parse_args().csrc)
