"""Weak scaling of the port's data-parallel paths over gloo ranks on the CPU
(``experiments/weak_scaling_r4.py`` of the JAX package).

At a fixed per-rank batch the total work grows with the number of ranks
``n``. Each rank is one process with one thread, pinned to a core of its
own (``n`` is at most ``len(os.sched_getaffinity(0))``), so ideal weak
scaling is

    wall(n) == wall(1),   overhead(n) = wall(n) / wall(1)

(JAX's harness puts ``n`` virtual devices on one shared core, where the
ideal is ``wall(n) = n wall(1)`` and ``overhead(n) = wall(n) / (n
wall(1))``). An overhead well above 1 exposes per-step synchronization,
redundant work that grows with ``n`` (each rank draws the whole batch's
noise and keeps its rows) or collective cost. Measured for the
data-parallel DiffCSP sample (``DiffCSPSampler.launch(sharding=...)``) and
the data-parallel MatterGen DDPO update (``MatterGenDDPOStep.run(...,
mesh=...)`` on each rank's rows of a recorded trajectory). ``wall(n)`` is
the least over ``repeats`` of the time from a barrier before the call to a
barrier after it, as rank 0 reads it, after one warm-up call.

    python -m matinvent_tpu_torch.experiments.weak_scaling [--ranks 1,2,4,8] \\
        [--out FILE] [reduced shapes: --per-rank-batch 8 --max-atoms 6 ...]

launches the ranks with ``dp_check``'s launcher and writes a JSON record
(the times, the overheads and their definition) to ``--out``, by default
``matinvent_tpu_torch/experiments/results/weak_scaling.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from matinvent_tpu_torch.experiments import dp_check

RESULTS = Path(__file__).resolve().parent / "results"
OVERHEAD = ("overhead(n) = wall(n) / wall(1): each rank is one process with one thread "
            "pinned to its own core, so ideal weak scaling at a fixed per-rank batch is "
            "wall(n) = wall(1); wall(n) is the least over the repeats of the time from a "
            "barrier before the call to a barrier after it, as rank 0 reads it")
# JAX's bound on the largest overhead over the measured rank counts
BOUND = 1.3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _timed(fn, repeats: int, barrier) -> float:
    fn()  # warm-up
    ts = []
    for _ in range(repeats):
        barrier()
        t0 = time.perf_counter()
        fn()
        barrier()
        ts.append(time.perf_counter() - t0)
    return float(min(ts))


def rank_main(job: dict) -> dict:
    """One rank's measurement (``job`` as ``measure`` writes it)."""
    import torch.distributed as dist

    from matinvent_tpu_torch.models.diffcsp import DiffCSPConfig, DiffCSPDiffusion
    from matinvent_tpu_torch.models.mattergen.diffusion import (
        MatterGenConfig,
        MatterGenDiffusion,
        RowNoise,
    )
    from matinvent_tpu_torch.models.sample import DiffCSPSampler
    from matinvent_tpu_torch.parallel.mesh import batch_sharding, init_from_env, make_mesh
    from matinvent_tpu_torch.parallel.train import MatterGenDDPOStep

    torch.set_num_threads(1)
    joined = init_from_env("cpu", "gloo")
    mesh = make_mesh(device=joined if joined is not None else "cpu")
    cores = job["cores"]
    os.sched_setaffinity(0, {cores[mesh.rank % len(cores)]})
    n, c = mesh.size, job["config"]
    B, A = c["per_rank_batch"] * n, c["max_atoms"]

    def barrier():
        if dist.is_initialized():
            dist.barrier()

    torch.manual_seed(0)
    diff = DiffCSPDiffusion(DiffCSPConfig(hidden_dim=c["hidden"], num_layers=c["layers"],
                                          time_dim=32, timesteps=c["timesteps"]), device="cpu").eval()
    sharding = batch_sharding(mesh)

    def sample():
        DiffCSPSampler(batch_size=B, num_batches=1, max_atoms=A, step_lr=1e-5,
                       seed=2).launch(diff, sharding=sharding)

    sample_s = _timed(sample, c["repeats"], barrier)

    torch.manual_seed(1)
    mg = MatterGenDiffusion(MatterGenConfig(hidden_dim=c["hidden"], num_layers=c["layers"],
                                            time_dim=32, timesteps=c["ddpo_timesteps"]),
                            device="cpu").eval()
    rows = mesh.rows(B)
    na = torch.full((B,), A, dtype=torch.int32)[rows]
    _, traj = mg.sample(RowNoise(torch.Generator().manual_seed(3), rows, B), na, max_atoms=A,
                        record_traj=True)
    mask = torch.ones(na.shape[0], A, dtype=torch.bool)
    advantages = torch.as_tensor(np.random.default_rng(0).random(B), dtype=torch.float32)[rows]
    start = {k: v.clone() for k, v in mg.state_dict().items()}

    def ddpo():
        mg.load_state_dict(start)
        MatterGenDDPOStep(lr=1e-4, chunk=c["ddpo_timesteps"], epochs=1).run(
            mg, traj, na, mask, advantages, mesh=mesh)

    ddpo_s = _timed(ddpo, c["repeats"], barrier)
    return {"rank": mesh.rank, "size": n, "sample_s": sample_s, "ddpo_s": ddpo_s,
            "core": cores[mesh.rank % len(cores)]}


def measure(ranks=(1, 2, 4, 8), per_rank_batch: int = 32, max_atoms: int = 8,
            timesteps: int = 100, hidden: int = 64, layers: int = 2, ddpo_timesteps: int = 16,
            repeats: int = 3, timeout: float = 1800.0) -> dict:
    """Wall times and overheads of both paths at each rank count (JAX's
    defaults; rank counts beyond this process's cores are left out)."""
    cores = sorted(os.sched_getaffinity(0))
    ranks = [n for n in ranks if n <= len(cores)]
    if 1 not in ranks:
        raise ValueError("the rank counts must include 1, the baseline")
    config = dict(per_rank_batch=per_rank_batch, max_atoms=max_atoms, timesteps=timesteps,
                  hidden=hidden, layers=layers, ddpo_timesteps=ddpo_timesteps, repeats=repeats)
    out = {"config": config, "ranks": ranks, "cores": len(cores), "sample_s": {}, "ddpo_s": {}}
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as work:
        for n in ranks:
            job = Path(work) / f"job{n}.json"
            res = Path(work) / f"res{n}"
            job.write_text(json.dumps({"config": config, "cores": cores, "out": str(res)}))
            done = dp_check.launch(job, n, _free_port(), timeout, env,
                                   module="matinvent_tpu_torch.experiments.weak_scaling")
            bad = [p.stdout for p in done if p.returncode != 0]
            if bad:
                raise RuntimeError(f"weak scaling at {n} ranks failed:\n" + "\n".join(bad)[-4000:])
            rec = json.loads(Path(f"{res}.rank0.json").read_text())
            out["sample_s"][n], out["ddpo_s"][n] = rec["sample_s"], rec["ddpo_s"]
    for kind in ("sample", "ddpo"):
        out[f"{kind}_overhead"] = {n: out[f"{kind}_s"][n] / out[f"{kind}_s"][1] for n in ranks}
    out["overhead_definition"] = OVERHEAD
    out["bound"] = BOUND
    return out


def main(argv: list[str] | None = None) -> dict | int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--job", help="run one rank of a measurement (set by the launcher)")
    ap.add_argument("--ranks", default="1,2,4,8")
    ap.add_argument("--per-rank-batch", type=int, default=32)
    ap.add_argument("--max-atoms", type=int, default=8)
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--ddpo-timesteps", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=str(RESULTS / "weak_scaling.json"))
    args = ap.parse_args(argv)
    if args.job:
        job = json.loads(Path(args.job).read_text())
        rec = rank_main(job)
        Path(f"{job['out']}.rank{rec['rank']}.json").write_text(json.dumps(rec))
        if torch.distributed.is_initialized():
            torch.distributed.barrier()
            torch.distributed.destroy_process_group()
        return 0
    res = measure(tuple(int(n) for n in args.ranks.split(",")), args.per_rank_batch,
                  args.max_atoms, args.timesteps, args.hidden, args.layers, args.ddpo_timesteps,
                  args.repeats)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=2) + "\n")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
