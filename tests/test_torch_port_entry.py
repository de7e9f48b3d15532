"""The port's config-driven entry points (``main``, ``Baseline``,
``gen_eval``) against the JAX package's, on the CPU, at a tiny size.

``main`` runs one iteration with the overrides of the JAX package's own
end-to-end test (``tests/test_pipeline.py``): it writes the artifacts that
test asks of JAX's ``main`` and an ``hparams.yaml`` equal to JAX's
composition but for the ``_target_`` package prefix. ``Baseline`` leaves
the weights bit-equal. ``gen_eval`` writes a ``metrics.json`` with the keys
of JAX's record, and its fractions equal what JAX's ``OptEval`` gives on the
same generated structures (exactly: the metrics are host-side counts).
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import pytest
import torch
import yaml

from matinvent_tpu.utils.config import load_config as jax_load_config
from matinvent_tpu_torch import gen_eval, main as cli
from matinvent_tpu_torch.pipeline.baseline import Baseline
from matinvent_tpu_torch.pipeline.mat_invent import MatInvent

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "data" / "reference.extxyz"
REFERENCE_ENERGIES = ROOT / "experiments" / "data" / "reference_energies.json"
GEN_EVAL_RECORD = ROOT / "experiments" / "results" / "gen_eval_1024_r5_metrics.json"
TINY = [
    "model.model_cfg.hidden_dim=32", "model.model_cfg.num_layers=2",
    "model.model_cfg.time_dim=16", "model.model_cfg.timesteps=10",
]
# tests/test_pipeline.py's TestEndToEnd overrides
E2E = [
    "expname=smoke", "rl_epoch=1", "eval_size=2", "seed=0", "reward=density", "logger=csv",
    *TINY, "model.model_cfg.sample_clip=15.0", "model.sample_cfg.batch_size=6",
    "model.finetune_cfg.timesteps=10", "pipeline.finetune_cfg.accum_steps=5",
    "pipeline.finetune_cfg.epochs=1", "pipeline.save_freq=1", "sample_cfg.filter=null",
    "sample_cfg.invalid_filter=false",
]


def _strip_targets(node):
    if isinstance(node, dict):
        return {k: (v.replace("matinvent_tpu_torch.", "matinvent_tpu.") if k == "_target_" else
                    _strip_targets(v)) for k, v in node.items()}
    if isinstance(node, list):
        return [_strip_targets(v) for v in node]
    return node


def test_main_runs_one_iteration_with_jax_s_artifacts(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = [f"results_dir={tmp_path}", *E2E]
    pipe = cli.main(argv + ["device=cpu"])
    assert isinstance(pipe, MatInvent) and pipe.agent.device.type == "cpu"
    run = tmp_path / "smoke"
    assert Path.cwd() == run
    for rel in ("hparams.yaml", "metrics.csv", "samples/step_0000_valid.extxyz",
                "samples/long_term_memory.csv", "models/final/params.msgpack"):
        assert (run / rel).exists(), rel
    hp = yaml.safe_load((run / "hparams.yaml").read_text())
    assert hp["model"]["_target_"] == "matinvent_tpu_torch.models.suite.diffcsp.DiffCSPSuite"
    assert _strip_targets(hp) == jax_load_config(str(ROOT / "configs"), "base", argv)
    header = (run / "metrics.csv").read_text().splitlines()[0].split(",")
    assert "reward mean" in header or "crystal_num" in header


def test_main_composes_every_group_through_the_default_filter(tmp_path, monkeypatch):
    """``configs/`` defaults (the base ``OptFilter`` with the disordered
    matcher) with MatterGen, the HHI reward and ``--device cpu``."""
    monkeypatch.chdir(tmp_path)
    pipe = cli.main([f"results_dir={tmp_path}", "expname=mg", "model=mattergen", "rl_epoch=1",
                     "eval_size=4", *TINY, "model.finetune_cfg.timesteps=10",
                     "pipeline.finetune_cfg.accum_steps=5", "pipeline.finetune_cfg.epochs=1",
                     "--device", "cpu"])
    from matinvent_tpu_torch.pipeline.filters import OptFilter

    assert isinstance(pipe.filter, OptFilter)
    assert type(pipe.filter.matcher).__name__ == "DisorderedStructureMatcher"
    assert (tmp_path / "mg" / "samples" / "step_0000_valid.extxyz").exists()


def test_baseline_runs_and_leaves_the_weights(tmp_path, monkeypatch):
    """``pipeline=baseline``: one metrics row per iteration, no saved
    model, the agent bit-equal to the loaded weights."""
    monkeypatch.chdir(tmp_path)
    pipe = cli.main([f"results_dir={tmp_path}", "expname=bl", "pipeline=baseline", "rl_epoch=2",
                     "eval_size=2", "seed=0", "reward=density", *TINY,
                     "model.model_cfg.sample_clip=15.0", "model.sample_cfg.batch_size=4",
                     "pipeline.sample_cfg.batch_size=4", "device=cpu"])
    assert isinstance(pipe, Baseline)
    fresh = pipe.model_suite.load_model()
    for k, v in fresh.state_dict().items():
        assert torch.equal(pipe.agent.state_dict()[k], v)
    rows = (tmp_path / "bl" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 3
    assert not (tmp_path / "bl" / "models" / "final").exists()
    for step in (0, 1):
        assert (tmp_path / "bl" / "samples" / f"step_{step:04d}_valid.extxyz").exists()
    assert (tmp_path / "bl" / "samples" / "long_term_memory.csv").exists()


def test_entry_points_refuse_what_they_cannot_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.pop_device(["a=1", "--device", "cpu", "b=2"]) == (["a=1", "b=2"], "cpu")
    assert cli.pop_device(["device=cuda:1", "--device=cpu"]) == ([], "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([f"results_dir={tmp_path}", "expname=x"])
        assert not (tmp_path / "x").exists()
    # ALIGNN builds; with no checkpoints it raises JAX's FileNotFoundError
    # when the iteration reaches scoring
    monkeypatch.delenv("ALIGNN_MODEL_DIR", raising=False)
    argv = [f"results_dir={tmp_path}", *[a for a in E2E if not a.startswith("reward=")],
            "reward=band_gap_alignn", "device=cpu"]
    with pytest.raises(FileNotFoundError, match="no model_dir"):
        cli.main(argv)
    assert (tmp_path / "smoke" / "samples" / "step_0000_valid.extxyz").exists()
    # MATINVENT_COORDINATOR at world size 1 on the CPU joins a gloo group
    # and runs the unsharded pipeline
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("MATINVENT_COORDINATOR", f"127.0.0.1:{port}")
    monkeypatch.setenv("MATINVENT_NUM_PROCESSES", "1")
    monkeypatch.setenv("MATINVENT_PROCESS_ID", "0")
    try:
        pipe = cli.main([f"results_dir={tmp_path}", *E2E[1:], "expname=c", "device=cpu"])
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert isinstance(pipe, MatInvent) and pipe.agent.device.type == "cpu"
        assert (tmp_path / "c" / "metrics.csv").exists()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_gen_eval_writes_jax_s_keys_and_opt_eval_s_fractions(tmp_path):
    """A tiny MatterGen run, both tiers, with the reference set's hull and
    ``num_atoms_from``: ``metrics.json`` has the keys of JAX's record, and
    each tier's fractions are JAX's ``OptEval`` on the generated structures
    with the same energies."""
    import numpy as np

    from matinvent_tpu.chem.proxy_labels import formation_energy_ev_per_atom
    from matinvent_tpu.chem.structure import read_extxyz
    from matinvent_tpu.pipeline.filters import OptEval, ReferenceDataset

    out = tmp_path / "ge"
    metrics = gen_eval.main([
        "model=mattergen", *TINY, "model.sample_cfg.max_atoms=6", f"output_dir={out}",
        "batch_size=6", "num_batches=2", f"reference_path={REFERENCE}",
        f"reference_energies={REFERENCE_ENERGIES}", f"num_atoms_from={REFERENCE}",
        "structure_matcher=disordered,ordered", "device=cpu",
    ])
    written = json.loads((out / "metrics.json").read_text())
    assert written == metrics
    record = json.loads(GEN_EVAL_RECORD.read_text())
    assert set(written) == set(record)
    assert set(written["by_matcher"]) == set(record["by_matcher"])
    assert written["num_generated"] == 12
    strucs = read_extxyz(str(out / "generated_crystals.extxyz"))
    assert len(strucs) == 12
    energies = [formation_energy_ev_per_atom(s) * s.num_atoms for s in strucs]
    energies = [e if np.isfinite(e) else None for e in energies]
    reference = ReferenceDataset.from_files(str(REFERENCE), str(REFERENCE_ENERGIES))
    for tier in ("disordered", "ordered"):
        ref, _ = OptEval(relax=False, reference=reference, structure_matcher=tier)(
            strucs, energies=energies)
        assert written["by_matcher"][tier] == ref, tier
        assert set(ref) == set(record["by_matcher"][tier])


def test_gen_eval_relaxes_on_the_device_and_rejects_unknown_arguments(tmp_path):
    metrics = gen_eval.main([
        "model=mattergen", *TINY, "model.sample_cfg.max_atoms=4", f"output_dir={tmp_path}",
        "batch_size=4", "num_batches=1", "relax=true", "device=cpu",
    ])
    assert metrics["num_generated"] == 4 and metrics["structure_matcher"] == "disordered"
    assert "by_matcher" not in metrics and "frac_stable" not in metrics
    with pytest.raises(ValueError, match="unknown arguments"):
        gen_eval.main([f"output_dir={tmp_path}", "bogus=1", "device=cpu"])
    assert os.path.exists(tmp_path / "generated_crystals.extxyz")


def test_the_committed_1024_record_is_within_4_sigma_of_jax_s():
    """The port's gen_eval 1024 record (H100) against JAX's: every fraction
    of both tiers within 4 binomial sigma at n=1024."""
    from matinvent_tpu_torch.experiments.compare_gen_eval import compare

    ours = json.loads((ROOT / "matinvent_tpu_torch/experiments/results/gen_eval_1024_r5/"
                       "metrics.json").read_text())
    out = compare(ours, json.loads(GEN_EVAL_RECORD.read_text()))
    assert ours["num_generated"] == 1024 and len(out["fractions"]) == 10
    assert out["within"], out
    shifted = json.loads(json.dumps(ours))
    shifted["by_matcher"]["disordered"]["frac_validity"] += 0.07  # 4.7 sigma
    assert not compare(shifted, json.loads(GEN_EVAL_RECORD.read_text()))["within"]
