"""Data-parallel runs of the port's dp paths, each held against one process.

    MATINVENT_COORDINATOR=127.0.0.1:PORT MATINVENT_NUM_PROCESSES=2 \\
    MATINVENT_PROCESS_ID=r python -m matinvent_tpu_torch.experiments.dp_check \\
        --job JOB.json

runs the tasks of ``JOB.json`` as rank ``r`` of the process group that the
three ``MATINVENT_*`` variables name (``parallel/mesh.py``'s
``init_from_env``, as the entry point joins it). Without them it runs them
in one process: the reference. ``launch`` starts the ranks and waits for
them. The job: ``{"device": "cpu" | "cuda", "backend": null | "gloo",
"out": DIR, "tasks": [...]}``; each task ``{"kind", "name", ...}`` writes
``DIR/<name>.rank<r>.pt``:

* ``diffcsp_sample`` (``model``, ``batch``, ``max_atoms``, ``step_lr``,
  ``seed``, ``record``; or ``noise``, an ``.npz`` of fixed whole-batch
  draws with their ``num_atoms``): ``DiffCSPSampler.launch(sharding=...)``
  (or ``DiffCSPDiffusion.sample`` on the draws' rows), the ranks' crystals
  gathered in rank order; with ``record`` the sampler's trajectory too;
  with ``draws`` (either sampler) the checksums of every row's draws
  (``DrawSums``), gathered;
* ``mattergen_sample`` (``model``, ``num_atoms``, ``max_atoms``, ``seed``,
  ``record``): ``MatterGenDiffusion.sample`` on the rank's rows of the
  whole batch's draws (``RowNoise``), gathered; with ``record`` the
  trajectory too (on the plain net), else the edge kernel's launches of
  this rank; ``traj_steps`` keeps a recorded trajectory's first steps
  alone; with ``"gather": false`` either sampler returns the rank's
  block alone, so that one process can run the ranks' blocks in turn
  (``Mesh(size, rank, device)`` without a group);
* ``ddpo`` (``model``; ``traj``, a file of a whole-batch trajectory with
  its ``num_atoms`` (or a ``mattergen_sample`` result's ``batch``) and
  ``rewards``, or ``traj_from``, an earlier recording task of the job;
  ``rewards`` may be given in the task; ``lr``, ``chunk``, ``epochs``,
  ``clip_eps``, ``max_grad_norm``): ``MatterGenDDPOStep.run`` over the
  rank's rows; the weights after it and the ratio statistics;
* ``finetune`` (``model``, ``batch``: a file of a whole batch and its
  ``rewards``; ``timesteps``, ``accum_steps``, ``sigma_kl``, ``lr``,
  ``seed``): one ``FinetuneStep`` epoch of the agent against its frozen
  copy over the rank's rows; the weights after it and the metrics.

and ``mesh`` (``batch``): the mesh's own operations (``shard_batch``,
``replicate``, gathers and reductions) as this rank sees them.

A ``model`` is ``{"family": "mattergen" | "diffcsp", "path": checkpoint
dir, "overrides": {...}}`` or ``{"family", "pt": file of {"config",
"state"}}``.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.diffcsp import (
    CSPArrayNoise,
    CSPGeneratorNoise,
    CSPRowNoise,
    DiffCSPConfig,
    DiffCSPDiffusion,
)
from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
    RowNoise,
    StepDraws,
)
from matinvent_tpu_torch.models.sample import DiffCSPSampler
from matinvent_tpu_torch.models.suite.diffcsp import DiffCSPSuite
from matinvent_tpu_torch.models.suite.mattergen import load_model
from matinvent_tpu_torch.ops.fused_edge import fused_edge_chain
from matinvent_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    gather_batch,
    init_from_env,
    make_mesh,
    replicate,
    shard_batch,
)
from matinvent_tpu_torch.parallel.train import FinetuneStep, MatterGenDDPOStep


def build_model(spec: dict, device) -> torch.nn.Module:
    family = spec["family"]
    if "pt" in spec:
        blob = torch.load(spec["pt"], map_location="cpu", weights_only=True)
        cls, cfg_cls = ((MatterGenDiffusion, MatterGenConfig) if family == "mattergen"
                        else (DiffCSPDiffusion, DiffCSPConfig))
        model = cls(cfg_cls.from_dict(blob["config"]), device=device)
        model.load_state_dict(blob["state"], strict=True)
        return model.eval()
    if family == "mattergen":
        return load_model(spec["path"], device=device, config_overrides=spec.get("overrides"))
    return DiffCSPSuite(model_path=spec["path"], config_overrides=spec.get("overrides"),
                        device=device).load_model()


def save_model_spec(model: torch.nn.Module, path: str | Path) -> dict:
    """A ``pt`` model spec of ``model`` (its config and weights)."""
    family = "mattergen" if isinstance(model, MatterGenDiffusion) else "diffcsp"
    torch.save({"config": dataclasses.asdict(model.config),
                "state": {k: v.cpu() for k, v in model.state_dict().items()}}, str(path))
    return {"family": family, "pt": str(path)}


def _batch_dict(batch: CrystalBatch) -> dict:
    return {k: getattr(batch, k).cpu() for k in ("atom_types", "frac_coords", "lattice",
                                                  "num_atoms")}


def _gather(x, mesh: Mesh, task: dict):
    """Every rank's rows of ``x``, or this rank's alone with ``"gather":
    false`` (a rank's block sampled in one process, where ``mesh`` names
    the block and no group exists)."""
    return gather_batch(x, mesh) if task.get("gather", True) else x


class DrawSums:
    """A noise source (either family's) that passes ``inner``'s draws on
    and keeps an exact checksum of each row of every draw it hands out,
    the prior's and every step's: the sum of the row's bits as int64 (of
    the float32 values' bits), on the device. Equal checksums mean the rows
    drew the same numbers, whatever the row count or summation order."""

    def __init__(self, inner):
        self.inner = inner
        self.sums: list[torch.Tensor] = []

    def _keep(self, draws):
        for name, x in zip(getattr(draws, "_fields", [None] * len(draws)), draws):
            if isinstance(draws, StepDraws) and name == "corr":
                x = x.transpose(0, 1)  # [n_corrector, B, ...]: rows first
            x = x.contiguous()
            bits = x.view(torch.int32) if x.dtype == torch.float32 else x
            self.sums.append(bits.reshape(x.shape[0], -1).long().sum(1))
        return draws

    def prior(self, *args):
        return self._keep(self.inner.prior(*args))

    def step(self, *args):
        return self._keep(self.inner.step(*args))

    def rows(self) -> torch.Tensor:
        """``[rows, checksums]``, in draw order."""
        return torch.stack(self.sums, 1)


def _gather_traj(traj: dict, b: int, mesh: Mesh, task: dict) -> dict:
    """A trajectory ``[T, b, ...]`` of this rank's ``b`` rows, its first
    ``task["traj_steps"]`` steps when given, gathered on axis 1 as
    ``_gather`` gathers a batch; on the host."""
    steps = task.get("traj_steps")
    out = {}
    for k, v in traj.items():
        v = v if steps is None else v[:steps]
        if v.dim() >= 2 and v.shape[1] == b:
            v = _gather(v.transpose(0, 1).contiguous(), mesh, task).transpose(0, 1)
        out[k] = v.cpu()
    return out


def diffcsp_sample(task: dict, mesh: Mesh, done: dict) -> dict:
    model = build_model(task["model"], mesh.device)
    sharding = batch_sharding(mesh)
    log = None
    if task.get("draws"):
        sample = model.sample

        def logged(noise, *args, **kwargs):
            nonlocal log
            log = DrawSums(CSPGeneratorNoise(noise) if isinstance(noise, torch.Generator)
                           else noise)
            return sample(log, *args, **kwargs)

        model.sample = logged
    if task.get("noise"):
        d = np.load(task["noise"])
        na = d["num_atoms"]
        rows = sharding.rows(len(na))
        noise = CSPRowNoise(CSPArrayNoise((d["x"], d["l"], d["tt"]), d["corr"], d["lattice"],
                                          d["types"], d["coords"]), rows, len(na))
        local, _ = model.sample(noise, torch.as_tensor(na[rows], device=mesh.device),
                                max_atoms=task["max_atoms"], step_lr=task["step_lr"])
    else:
        sampler = DiffCSPSampler(batch_size=task["batch"], num_batches=1,
                                 max_atoms=task["max_atoms"], step_lr=task["step_lr"],
                                 seed=task["seed"], record_trajectories=task.get("record", False))
        local = sampler.launch(model, sharding=sharding)
    b = int(local.num_atoms.shape[0])
    res = {"rows": b, "batch": _batch_dict(_gather(local, mesh, task))}
    if task.get("record"):
        res["traj"] = _gather_traj(sampler.last_trajectory, b, mesh, task)
    if log is not None:
        res["draws"] = _gather(log.rows(), mesh, task).cpu()
    return res


def mattergen_sample(task: dict, mesh: Mesh, done: dict) -> dict:
    model = build_model(task["model"], mesh.device)
    na = np.asarray(task["num_atoms"])
    rows = mesh.rows(len(na))
    gen = torch.Generator(device=mesh.device).manual_seed(task["seed"])
    noise = RowNoise(gen, rows, len(na))
    if task.get("draws"):
        noise = DrawSums(noise)
    local_na = torch.as_tensor(na[rows], device=mesh.device)
    record = task.get("record", False)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    fused_edge_chain.launches = 0
    t = time.perf_counter()
    out = model.sample(noise, local_na, max_atoms=task["max_atoms"], record_traj=record)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = fused_edge_chain.launches
    final, traj = out if record else (out, None)
    res = {"rows": int(local_na.shape[0]), "launches": launches, "seconds": seconds,
           "plan": 0 if record else model.planned_launches(),
           "batch": _batch_dict(_gather(final, mesh, task))}
    if record:
        res["traj"] = _gather_traj(traj, rows.stop - rows.start, mesh, task)
    if task.get("draws"):
        res["draws"] = _gather(noise.rows(), mesh, task).cpu()
    return res


def _shard_traj(traj: dict, B: int, mesh: Mesh) -> dict:
    """The trajectory's rows of this rank (axis 1), on its device."""
    rows = mesh.rows(B)
    return {k: (v[:, rows] if v.dim() >= 2 and v.shape[1] == B and k != "step" else v
                ).to(mesh.device) for k, v in traj.items()}


def ddpo(task: dict, mesh: Mesh, done: dict) -> dict:
    agent = replicate(build_model(task["model"], mesh.device), mesh)
    blob = done[task["traj_from"]] if "traj_from" in task else \
        torch.load(task["traj"], map_location="cpu", weights_only=True)
    na = blob["num_atoms"] if "num_atoms" in blob else blob["batch"]["num_atoms"]
    rewards = torch.as_tensor(task.get("rewards", blob.get("rewards")), dtype=torch.float32)
    B = int(na.shape[0])
    traj = _shard_traj(blob["traj"], B, mesh)
    na, rewards = shard_batch((na, rewards), mesh)
    mask = torch.arange(task["max_atoms"], device=mesh.device)[None, :] < na[:, None]
    step = MatterGenDDPOStep(lr=task["lr"], chunk=task["chunk"], epochs=task["epochs"],
                             clip_eps=task.get("clip_eps", 0.2),
                             max_grad_norm=task["max_grad_norm"])
    replay = step.replay_stats(agent, traj, na, mask, mesh=mesh)
    loss = step.run(agent, traj, na, mask, rewards, mesh=mesh)
    return {"loss": loss, "replay": replay, "epoch_stats": step.epoch_stats,
            "state": {k: v.cpu() for k, v in agent.state_dict().items()}}


def finetune(task: dict, mesh: Mesh, done: dict) -> dict:
    agent = replicate(build_model(task["model"], mesh.device), mesh)
    prior = copy.deepcopy(agent).requires_grad_(False)
    blob = torch.load(task["batch"], map_location="cpu", weights_only=True)
    batch = CrystalBatch(**{k: blob[k] for k in ("atom_types", "frac_coords", "lattice",
                                                  "num_atoms")})
    batch, rewards = shard_batch((batch, blob["rewards"]), mesh)
    step = FinetuneStep(timesteps=task["timesteps"], lr=task["lr"],
                        accum_steps=task["accum_steps"], sigma_kl=task["sigma_kl"], epochs=1)
    gen = torch.Generator(device=mesh.device).manual_seed(task["seed"])
    metrics = step.run(agent, prior, batch, rewards, generator=gen, mesh=mesh)
    return {"metrics": metrics, "state": {k: v.cpu() for k, v in agent.state_dict().items()}}


def mesh_task(task: dict, mesh: Mesh, done: dict) -> dict:
    """The mesh's own operations: this rank's rows of ``shard_batch``, a
    module's weights after ``replicate`` (initialized differently on each
    rank), every rank's rows gathered, a sum and a max reduced."""
    import torch.distributed as dist

    B = task["batch"]
    rows = shard_batch({"x": torch.arange(B * 3).reshape(B, 3), "y": np.arange(B)}, mesh)
    torch.manual_seed(100 + mesh.rank)
    net = replicate(torch.nn.Linear(3, 2).to(mesh.device), mesh)
    mine = torch.full((2, 2), float(mesh.rank), device=mesh.device)
    return {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "rows": rows["x"].cpu(), "rows_np": rows["y"],
            "weights": {k: v.cpu() for k, v in net.state_dict().items()},
            "gathered": mesh.all_gather_rows(mine).cpu(),
            "sum": float(mesh.all_reduce_(torch.tensor([mesh.rank + 1.0], device=mesh.device))),
            "max": float(mesh.all_reduce_(torch.tensor([mesh.rank + 1.0], device=mesh.device),
                                          "max"))}


TASKS = {"mesh": mesh_task, "diffcsp_sample": diffcsp_sample, "mattergen_sample": mattergen_sample,
         "ddpo": ddpo, "finetune": finetune}


def run_job(job: dict, mesh: Mesh | None = None) -> dict:
    """Every task of ``job`` on ``mesh`` (this process alone by default);
    each result is written to ``<out>/<name>.rank<r>.pt`` and returned."""
    mesh = mesh or make_mesh(device=job["device"])
    out = Path(job["out"])
    out.mkdir(parents=True, exist_ok=True)
    results = {}
    for task in job["tasks"]:
        res = TASKS[task["kind"]](task, mesh, results)
        torch.save(res, str(out / f"{task['name']}.rank{mesh.rank}.pt"))
        results[task["name"]] = res
    return results


def start(job_path: str | Path, ranks: int, port: int,
          env: dict | None = None,
          module: str = "matinvent_tpu_torch.experiments.dp_check") -> list[subprocess.Popen]:
    """Start ``job_path`` as ``ranks`` processes of one group at
    ``127.0.0.1:port``, each ``python -m module --job job_path`` (this
    module's by default; ``wait`` collects them)."""
    procs = []
    for r in range(ranks):
        e = dict(os.environ if env is None else env)
        e.update(MATINVENT_COORDINATOR=f"127.0.0.1:{port}", MATINVENT_NUM_PROCESSES=str(ranks),
                 MATINVENT_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, "--job", str(job_path)], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def wait(procs: list[subprocess.Popen], timeout: float) -> list[subprocess.CompletedProcess]:
    """The ranks' completed processes; kills those still running when the
    time runs out (or on any error), so none outlives the call."""
    done = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            done.append(subprocess.CompletedProcess(p.args, p.returncode, out, ""))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


def launch(job_path: str | Path, ranks: int, port: int, timeout: float,
           env: dict | None = None,
           module: str = "matinvent_tpu_torch.experiments.dp_check") -> list[subprocess.CompletedProcess]:
    """``start`` then ``wait``."""
    return wait(start(job_path, ranks, port, env, module), timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--job", required=True)
    args = ap.parse_args(argv)
    job = json.loads(Path(args.job).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    joined = init_from_env(job["device"], job.get("backend"))
    mesh = make_mesh(device=joined if joined is not None else job["device"])
    torch.set_num_threads(job.get("threads", torch.get_num_threads()))
    run_job(job, mesh)
    print(f"dp_check rank {mesh.rank} of {mesh.size}: {len(job['tasks'])} tasks done", flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
