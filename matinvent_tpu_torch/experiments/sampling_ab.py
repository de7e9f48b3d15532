"""The RL iteration's sampling in two checkouts of the repository, timed on
the card in one run.

    python matinvent_tpu_torch/experiments/sampling_ab.py --trees OLD NEW

The sampling is that of the ``rl_hhi_rich5`` recipe: 64 crystals from the
``corpus_r5`` histogram, one size bucket, f32, T=1000, through the
fused-edge kernel, with the start checkpoint of this checkout. Each run is
a fresh process that imports the package from its tree (and builds the
kernel there); the runs go OLD, NEW, NEW, OLD so that drift on the card
weighs on both alike. A run reports the host-clock seconds of one
``MatterGenSampler.launch`` at T=1000 (ended by a synchronize), and, from
a profiled launch of 20 grid steps, the kernels launched and their device
time per grid step. Prints one JSON record.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
START = ROOT / "experiments/results/pretrained_geneval_r5_r5_long_s120000_ema"
HIST = ROOT / "experiments/data/corpus_r5_num_atoms.json"
BATCH, MAX_ATOMS, PROFILED_STEPS = 64, 20, 20


def worker(tree: str) -> dict:
    """One run, in this process, of the package found in ``tree``."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    from matinvent_tpu_torch.models.mattergen import sample
    from matinvent_tpu_torch.models.suite.mattergen import load_model

    hist = json.loads(HIST.read_text())["corpus_r5"]
    arr = np.zeros(max(int(k) for k in hist) + 1)
    for k, v in hist.items():
        arr[int(k)] = float(v)
    sample.NUM_ATOMS_DISTRIBUTIONS["corpus_r5"] = arr / arr.sum()
    torch.backends.cuda.matmul.allow_tf32 = False

    def sampler():
        return sample.MatterGenSampler(
            batch_size=BATCH, num_batches=1, max_atoms=MAX_ATOMS,
            num_atoms_distribution="corpus_r5", seed=0,
        )

    # T sets the grid, not the work of a step: a short grid counts a step
    short = load_model(START, device="cuda", config_overrides={"timesteps": PROFILED_STEPS})
    sampler().launch(short)  # builds the kernel, warms the caches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sampler().launch(short)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    model = load_model(START, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler().launch(model)
    torch.cuda.synchronize()
    return dict(
        tree=tree, sample_s=time.perf_counter() - t0,
        launches_per_step=len(kernels) / PROFILED_STEPS,
        device_ms_per_step=sum(e.time_range.elapsed_us() for e in kernels)
        / 1e3 / PROFILED_STEPS,
    )


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    parser.add_argument("--worker", metavar="TREE", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        rec = worker(args.worker)
        print(json.dumps(rec), flush=True)
        return rec
    old, new = args.trees
    runs = []
    for tree in (old, new, new, old):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", tree],
            capture_output=True, text=True, timeout=900,
        )
        if proc.returncode:
            raise RuntimeError(f"run of {tree} failed:\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    rec = dict(experiment="sampling_ab", nvidia_smi=smi, crystals=BATCH, timesteps=1000,
               runs=runs,
               mean_sample_s={t: sum(r["sample_s"] for r in runs if r["tree"] == t) / 2
                              for t in (old, new)})
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
