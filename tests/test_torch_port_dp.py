"""Data parallel on ``torch.distributed``: two ``gloo`` ranks on the CPU
against one process, and against JAX's ``dp``-sharded sampling.

One job of ``matinvent_tpu_torch.experiments.dp_check`` runs as two
processes that join their group from the three ``MATINVENT_*`` variables,
as the entry point does, and once in this process (the reference). The
models are tiny and random (h16, one layer, T=6), JAX's weights scaled by
0.02 as the JAX package's own sharded-sampling test scales them. Held:

* the mesh: ranks, the ``gloo`` backend, ``shard_batch``'s contiguous
  blocks, ``replicate`` (rank 0's weights), gathers in rank order;
* DiffCSP sampling sharded over the two ranks and gathered equals the
  single process within 1e-5 with the atom types exact, both through
  ``DiffCSPSampler.launch(sharding=...)`` (also recording, with the
  trajectory's first steps gathered and the checksums of every row's
  draws equal) and on JAX's draws, where it
  also equals JAX's own sample sharded over a two-device ``dp`` mesh (the
  lattices, which the untrained chain drives to several hundred, within
  1e-5 of their scale);
* a recorded MatterGen sample sharded and gathered equals the single
  process (1e-5, types exact), trajectory and draw checksums included; no
  edge kernel runs on the CPU;
* one ``MatterGenDDPOStep`` run (unclipped, and with the gradient clip and
  the PPO ratio clip both engaged) and one ``FinetuneStep`` epoch over the
  two ranks' rows give the single process's weights within 1e-6 of the
  model's weight scale, and its losses and ratio statistics.
"""
from __future__ import annotations

import json
import os
import socket
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matinvent_tpu.models.diffcsp import DiffCSPConfig as JaxConfig
from matinvent_tpu.models.diffcsp import DiffCSPDiffusion as JaxDiffusion
from matinvent_tpu_torch.experiments import dp_check
from matinvent_tpu_torch.models.diffcsp import DiffCSPConfig, DiffCSPDiffusion
from matinvent_tpu_torch.models.mattergen.diffusion import MatterGenConfig, MatterGenDiffusion
from matinvent_tpu_torch.models.suite.mattergen import params_from_jax
from matinvent_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RANKS, B, A, T = 2, 16, 4, 6
CSP = dict(hidden_dim=16, num_layers=1, time_dim=8, timesteps=T)
SAMPLE_TOL, UPDATE_TOL = 1e-5, 1e-6


def _jax_sample_draws(key, B_, A_, K, T_):
    """The draws ``DiffCSPDiffusion.sample`` makes from ``key``."""
    k_x, k_l, k_t, k_scan = jax.random.split(key, 4)
    out = {"x": np.array(jax.random.uniform(k_x, (B_, A_, 3))),
           "l": np.array(jax.random.normal(k_l, (B_, 3, 3))),
           "tt": np.array(jax.random.normal(k_t, (B_, A_, K)))}
    steps = {"corr": [], "lattice": [], "types": [], "coords": []}
    for t in range(T_, 0, -1):
        kc, kl, kt, kx = jax.random.split(jax.random.fold_in(k_scan, t), 4)
        steps["corr"].append(np.array(jax.random.normal(kc, (B_, A_, 3))))
        steps["lattice"].append(np.array(jax.random.normal(kl, (B_, 3, 3))))
        steps["types"].append(np.array(jax.random.normal(kt, (B_, A_, K))))
        steps["coords"].append(np.array(jax.random.normal(kx, (B_, A_, 3))))
    return {**out, **{k: np.stack(v) for k, v in steps.items()}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    # DiffCSP: JAX's weights (x 0.02) in both packages; JAX's draws and its
    # sample sharded over a two-device dp mesh
    jd = JaxDiffusion(JaxConfig(**CSP))
    params = jax.tree.map(lambda x: x * 0.02, jd.init_params(jax.random.PRNGKey(0), max_atoms=A))
    csp = DiffCSPDiffusion(DiffCSPConfig(**CSP), device="cpu")
    csp.load_state_dict({k: torch.tensor(v) for k, v in
                         params_from_jax(jax.tree.map(np.asarray, params)).items()}, strict=True)
    csp_spec = dp_check.save_model_spec(csp, tmp / "csp.pt")
    na = rng.integers(1, A + 1, B).astype(np.int32)
    key = jax.random.PRNGKey(1)
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

    jmesh = JMesh(np.array(jax.devices()[:RANKS]), ("dp",))
    jref, _ = jd.sample(jax.device_put(params, NamedSharding(jmesh, P())), key,
                        jax.device_put(jnp.asarray(na), NamedSharding(jmesh, P("dp"))),
                        max_atoms=A, step_lr=1e-5)
    np.savez(tmp / "draws.npz", num_atoms=na, **_jax_sample_draws(key, B, A, 100, T))

    # MatterGen: random weights (x 0.1), a recorded sample of the whole
    # batch in this process, and rewards for the DDPO update
    torch.manual_seed(0)
    mg = MatterGenDiffusion(MatterGenConfig(hidden_dim=16, num_layers=1, time_dim=8,
                                            timesteps=T), device="cpu")
    with torch.no_grad():
        for p in mg.parameters():
            p.mul_(0.1)
    mg_spec = dp_check.save_model_spec(mg, tmp / "mg.pt")
    mg_na = [int(v) for v in rng.integers(1, A + 1, B)]
    ref_mesh = make_mesh(device="cpu")
    rec = dp_check.mattergen_sample(dict(model=mg_spec, num_atoms=mg_na, max_atoms=A, seed=3,
                                         record=True), ref_mesh, {})
    torch.save({"traj": rec["traj"], "num_atoms": torch.tensor(mg_na),
                "rewards": torch.from_numpy(rng.random(B).astype(np.float32))},
               str(tmp / "traj.pt"))
    batch = rec["batch"]
    torch.save({**batch, "rewards": torch.from_numpy(rng.random(B).astype(np.float32))},
               str(tmp / "batch.pt"))

    common = dict(model=mg_spec, max_atoms=A, traj=str(tmp / "traj.pt"), chunk=T // 2)
    job = {"device": "cpu", "backend": None, "out": str(tmp / "out"), "threads": 1, "tasks": [
        dict(kind="mesh", name="mesh", batch=B),
        dict(kind="diffcsp_sample", name="csp_launch", model=csp_spec, batch=B, max_atoms=A,
             step_lr=1e-5, seed=4),
        dict(kind="diffcsp_sample", name="csp_rec", model=csp_spec, batch=B, max_atoms=A,
             step_lr=1e-5, seed=4, record=True, traj_steps=T // 2, draws=True),
        dict(kind="diffcsp_sample", name="csp_jax", model=csp_spec, max_atoms=A, step_lr=1e-5,
             noise=str(tmp / "draws.npz")),
        dict(kind="mattergen_sample", name="mg_rec", model=mg_spec, num_atoms=mg_na,
             max_atoms=A, seed=3, record=True, draws=True),
        dict(kind="mattergen_sample", name="mg", model=mg_spec, num_atoms=mg_na, max_atoms=A,
             seed=5, draws=True),
        dict(kind="ddpo", name="ddpo", lr=1e-3, epochs=1, max_grad_norm=1e6, **common),
        dict(kind="ddpo", name="ddpo_clipped", lr=1e-3, epochs=2, max_grad_norm=1e-3,
             clip_eps=1e-3, **common),
        dict(kind="finetune", name="finetune", model=mg_spec, batch=str(tmp / "batch.pt"),
             timesteps=T, accum_steps=T // 2, sigma_kl=0.1, lr=1e-3, seed=6),
    ]}
    (tmp / "job.json").write_text(json.dumps(job))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    procs = dp_check.launch(tmp / "job.json", RANKS, _free_port(), timeout=240, env=env)
    for p in procs:
        assert p.returncode == 0, p.stdout
    ranks = [{t["name"]: torch.load(str(tmp / "out" / f"{t['name']}.rank{r}.pt"),
                                    weights_only=False) for t in job["tasks"]}
             for r in range(RANKS)]
    ref = dp_check.run_job({**job, "out": str(tmp / "ref")})
    return dict(ranks=ranks, ref=ref, jax=jref)


def _close(got, want, tol, what):
    scale = max(float(want.abs().max()), 1e-12) if want.numel() else 1.0
    err = float((got.double() - want.double()).abs().max()) if want.numel() else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _same_draws(name, got, want):
    """The ranks' gathered draw checksums equal one process's, exactly."""
    if "draws" in want:
        # the prior (3 draws) and T steps of 4 draws each, per row
        assert want["draws"].shape == (B, 3 + 4 * T)
        assert torch.equal(got["draws"], want["draws"]), name


def _same_batch(got, want, tol=SAMPLE_TOL, lattice_of_scale=False):
    torch.testing.assert_close(got["atom_types"], want["atom_types"], rtol=0, atol=0)
    torch.testing.assert_close(got["num_atoms"], want["num_atoms"], rtol=0, atol=0)
    d = (got["frac_coords"] - want["frac_coords"]).abs()
    assert float(torch.minimum(d, 1 - d).max()) <= tol
    if lattice_of_scale:
        _close(got["lattice"], want["lattice"], tol, "lattice")
    else:
        torch.testing.assert_close(got["lattice"], want["lattice"], rtol=0, atol=tol)


def test_mesh_from_the_environment(run):
    for r, res in enumerate(run["ranks"]):
        m = res["mesh"]
        assert (m["rank"], m["size"], m["backend"], m["device"]) == (r, RANKS, "gloo", "cpu")
        k = B // RANKS
        np.testing.assert_array_equal(m["rows"].numpy(),
                                      np.arange(B * 3).reshape(B, 3)[r * k:(r + 1) * k])
        np.testing.assert_array_equal(m["rows_np"], np.arange(B)[r * k:(r + 1) * k])
        for name, v in m["weights"].items():
            assert torch.equal(v, run["ranks"][0]["mesh"]["weights"][name])
        assert m["gathered"].tolist() == [[0.0, 0.0], [0.0, 0.0], [1.0, 1.0], [1.0, 1.0]]
        assert (m["sum"], m["max"]) == (3.0, 2.0)
    ref = run["ref"]["mesh"]
    assert (ref["size"], ref["backend"]) == (1, None) and ref["rows"].shape == (B, 3)
    assert pad_to_multiple(13, 4) == 16 and pad_to_multiple(16, 4) == 16


@pytest.mark.parametrize("name", ["csp_launch", "csp_rec", "csp_jax"])
def test_sharded_diffcsp_sample_equals_one_process(run, name):
    for res in run["ranks"]:
        assert res[name]["rows"] == B // RANKS
        _same_batch(res[name]["batch"], run["ref"][name]["batch"])
        _same_draws(name, res[name], run["ref"][name])
    if name == "csp_rec":
        # the recorded trajectory's first T // 2 steps, gathered on axis 1
        got, want = run["ranks"][0][name]["traj"], run["ref"][name]["traj"]
        assert set(got) == set(want) and want["lattices"].shape[:2] == (T // 2, B)
        for k in want:
            _close(got[k], want[k], SAMPLE_TOL, k)
    if name == "csp_jax":
        # across packages the f32 products differ in order: the untrained
        # chain's lattices reach several hundred, held to 1e-5 of that scale
        got, jref = run["ranks"][0][name]["batch"], run["jax"]
        _same_batch(got, {k: torch.from_numpy(np.array(getattr(jref, k)))
                          for k in ("atom_types", "num_atoms", "frac_coords", "lattice")},
                    lattice_of_scale=True)


@pytest.mark.parametrize("name", ["mg_rec", "mg"])
def test_sharded_mattergen_sample_equals_one_process(run, name):
    for res in run["ranks"]:
        assert res[name]["launches"] == 0  # the kernel runs on the card only
        _same_batch(res[name]["batch"], run["ref"][name]["batch"])
        _same_draws(name, res[name], run["ref"][name])
    if name == "mg_rec":
        got, want = run["ranks"][0][name]["traj"], run["ref"][name]["traj"]
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], SAMPLE_TOL, k)


@pytest.mark.parametrize("name", ["ddpo", "ddpo_clipped", "finetune"])
def test_dp_update_equals_one_process(run, name):
    want = run["ref"][name]
    # the scale is the model's largest weight: Adam divides each gradient
    # entry by its own size, so an entry that sums to near 0 from larger
    # terms moves by a share of lr that their summation order sets
    scale = max(float(v.abs().max()) for v in want["state"].values() if v.is_floating_point())
    for res in run["ranks"]:
        for k, v in want["state"].items():
            err = float((res[name]["state"][k].double() - v.double()).abs().max())
            assert err <= UPDATE_TOL * scale, f"{name} {k}: {err} > {UPDATE_TOL} x {scale}"
    got = run["ranks"][0][name]
    if name == "finetune":
        for k, v in want["metrics"][0].items():
            assert abs(got["metrics"][0][k] - v) <= UPDATE_TOL * max(abs(v), 1e-12), k
        return
    # the last pass's loss and statistics are taken at the updated weights
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * max(abs(want["loss"]), 1e-3)
    # the replay at the recording weights: ratio 1, nothing clipped
    assert abs(got["replay"]["ratio_mean"] - 1.0) <= 1e-6 and got["replay"]["clip_frac"] == 0.0
    for st, ws in zip(got["epoch_stats"], want["epoch_stats"]):
        for k in ws:
            assert abs(st[k] - ws[k]) <= 1e-5 * max(abs(ws[k]), 1.0), (k, st[k], ws[k])
    if name == "ddpo_clipped":
        assert want["epoch_stats"][-1]["clip_frac"] > 0.0
