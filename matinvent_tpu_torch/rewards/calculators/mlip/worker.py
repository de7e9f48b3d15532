"""What the MLIP worker scripts (``elastic.py``, ``phonon.py``) run.

    python <phonon.py|elastic.py> <in.extxyz> <out.txt> <n_workers> [--device cuda|cpu]

reads the structures, computes one value per structure and writes them, one
per line. With quacc importable it runs quacc's MLIP workflow per
structure (``n_workers`` processes); otherwise the native soft-sphere
workflow of ``chem.phonon`` on ``--device`` (the card unless ``cpu`` is
given). It names its backend on stderr and, on the card, the peak device
memory. Any failure of the native workflow propagates, and the script
exits non-zero. quacc's workflow gives NaN for a structure it fails on;
an ImportError (a missing part of the MLIP stack), or a failure on every
structure (a model that cannot be loaded), ends the script non-zero.
"""
from __future__ import annotations

import argparse
import functools
import multiprocessing as mp
import sys
from typing import Callable, Sequence

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import Structure, read_extxyz
from matinvent_tpu_torch.device import resolve_device


def _quacc_atoms(structures: Sequence[Structure]):
    from ase import Atoms

    return [Atoms(numbers=s.species, scaled_positions=s.frac_coords % 1.0,
                  cell=s.lattice, pbc=True) for s in structures]


def _per_structure(task: Callable, atoms) -> tuple[float, str | None]:
    """``task(atoms)`` and None, or NaN and the error where the workflow
    fails on this structure; an ImportError propagates."""
    try:
        return float(task(atoms)), None
    except ImportError:
        raise
    except Exception as exc:  # this structure's workflow, not the stack
        return float("nan"), f"{type(exc).__name__}: {exc}"


def run(
    argv: Sequence[str],
    name: str,
    quacc_task: Callable,
    quacc_label: str,
    native: Callable[..., np.ndarray],
    native_label: str,
) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("xyz_path")
    parser.add_argument("out_path")
    parser.add_argument("n_workers", type=int)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    structures = read_extxyz(args.xyz_path)
    try:
        import quacc  # noqa: F401  (the MLIP stack)
    except ImportError:
        quacc = None
    if quacc is not None:
        print(f"[mlip/{name}] backend: {quacc_label}", file=sys.stderr)
        atoms = _quacc_atoms(structures)
        one = functools.partial(_per_structure, quacc_task)
        if args.n_workers > 1:
            with mp.get_context("spawn").Pool(args.n_workers) as pool:
                out = pool.map(one, atoms)
        else:
            out = [one(a) for a in atoms]
        errors = [e for _, e in out if e is not None]
        if out and len(errors) == len(out):
            raise RuntimeError(f"quacc's workflow failed on every structure: {errors[0]}")
        if errors:
            print(f"[mlip/{name}] NaN for {len(errors)} of {len(out)} structures "
                  f"(first: {errors[0]})", file=sys.stderr)
        results = [v for v, _ in out]
    else:
        # the fallback names itself: a broken quacc install would otherwise
        # give screening-grade numbers with no sign of it
        device = resolve_device(args.device)
        print(f"[mlip/{name}] backend: {native_label} (quacc not importable; "
              f"screening-grade) on {device}", file=sys.stderr)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        results = [float(v) for v in native(structures, device=device)]
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"[mlip/{name}] peak device memory {peak:.3f} GiB", file=sys.stderr)
    with open(args.out_path, "w") as fh:
        fh.write("\n".join(f"{v:.6f}" for v in results) + "\n")
