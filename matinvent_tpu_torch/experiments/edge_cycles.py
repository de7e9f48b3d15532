"""Where the fused edge kernel's time goes, phase by phase, on the card.

    python -m matinvent_tpu_torch.experiments.edge_cycles

Builds ``csrc/fused_edge.cu`` a second time with ``-DFUSED_EDGE_CYCLES``,
which closes each phase of the kernel's tile loop with a barrier and adds
block 0's clock cycles per phase to counters on the card, then launches it
at the harness shape of ``fused_edge_ab`` (203 crystals at cap 20, H = 256,
64 lanes) in mode ``full`` and ``gemmonly`` (bf16) and in mode ``full`` with
the same inputs in f32. Prints one JSON record: per run, block 0's cycles
per tile of each phase (the once-per-block ``prep`` per block). The extra
barriers cost a little, so the phases add up to slightly more than the
uninstrumented kernel's time; their shares are what the record is for.
"""
from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from matinvent_tpu_torch.csrc.build import build
from matinvent_tpu_torch.experiments.fused_edge_ab import (
    NF,
    ROWS_PER_TILE,
    make_inputs,
    persistent_blocks,
)
from matinvent_tpu_torch.experiments.timing import card
from matinvent_tpu_torch.ops.fused_edge import MODES

PHASES = ("prep", "rows", "emb", "gemm1", "epilogue1", "gemm2", "silu2", "jsum")


def main(crystals: int = 203, atoms: int = 20) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("edge_cycles measures on a CUDA card")
    lib = build("fused_edge", ("FUSED_EDGE_CYCLES",)).lib
    launch = lib.fused_edge_launch
    launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    read = lib.fused_edge_read_cycles
    read.argtypes = [ctypes.c_void_p]
    counters = (ctypes.c_ulonglong * 8)()
    args, _ = make_inputs(np.random.default_rng(0), crystals, atoms, "cuda")
    rows_i = ROWS_PER_TILE // atoms
    tiles = -(-crystals * atoms // rows_i)
    blocks = persistent_blocks(tiles)
    per_block = -(-tiles // blocks)  # tiles of block 0

    def run(mode, dtype):
        ti, tj, fr, ui, uj, fmat, wd, w1, b1 = args
        ti, tj, wd, w1, b1 = (t.to(dtype).contiguous() for t in (ti, tj, wd, w1, b1.reshape(-1)))
        out = torch.empty_like(ti)
        call = (MODES.index(mode), ti.data_ptr(), tj.data_ptr(), fr.data_ptr(), fmat.data_ptr(),
                None, ui.data_ptr(), uj.data_ptr(), wd.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                out.data_ptr(), crystals, atoms, ti.shape[-1], wd.shape[0], 3 * NF, 0,
                int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        for _ in range(2):  # the second launch is the one counted
            if launch(*call) != 0:
                raise RuntimeError(f"fused_edge_launch ({mode}) failed")
            torch.cuda.synchronize()
            if read(ctypes.addressof(counters)) != 0:
                raise RuntimeError("fused_edge_read_cycles failed")
        cycles = [int(c) for c in counters]
        per_tile = {p: c / (1 if p == "prep" else per_block) for p, c in zip(PHASES, cycles)}
        return dict(mode=mode, dtype=str(dtype).split(".")[-1], total_cycles=sum(cycles),
                    cycles_per_tile=per_tile)

    rec = dict(
        script="edge_cycles", device=card(), crystals=crystals, atoms=atoms,
        tiles=tiles, blocks=blocks, tiles_of_block0=per_block,
        runs=[run("full", torch.bfloat16), run("gemmonly", torch.bfloat16),
              run("full", torch.float32)],
    )
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
