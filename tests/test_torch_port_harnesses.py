"""The port's RL and conditional-generation harnesses
(``matinvent_tpu_torch/experiments/{rl_demo,rl_predictor_runs,
conditional_demo,cfg_ablation_r4,post_rl_gen_eval}.py``) and the archived
runs as recipes (``recipes.recipe_from_hparams``), held against the JAX
package's harnesses (``experiments/*.py``, imported by path) and records
on the CPU: the corpora byte for byte, the conditional batches, the
override lists each harness hands its entry point (JAX's captured with a
recorder in ``sys.modules["main"]`` / ``["gen_eval"]``), the summary
functions on JAX's recorded rows, the reward statistics of the archived
generations, every archived ``hparams.yaml`` as a recipe, and a tiny
``rl_demo`` end to end.
"""
from __future__ import annotations

import copy
import filecmp
import importlib.abc
import importlib.machinery
import importlib.util
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from matinvent_tpu_torch import gen_eval as port_gen_eval
from matinvent_tpu_torch import main as port_main
from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.experiments import (
    cfg_ablation_r4,
    conditional_demo,
    post_rl_gen_eval,
    rl_demo,
    rl_predictor_runs,
)
from matinvent_tpu_torch.models.suite.mattergen import load_config as mattergen_config
from matinvent_tpu_torch.pipeline import mat_invent
from matinvent_tpu_torch.recipes import ARCHIVE, RECIPES, recipe_from_hparams
from matinvent_tpu_torch.tools import pretrain as port_pretrain
from matinvent_tpu_torch.utils.config import read_flat_yaml

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "experiments/results"
ARCHIVED = sorted(p.parent.name for p in ARCHIVE.glob("*/hparams.yaml"))
# the hand-written recipes of earlier slices that transcribed an archive
TRANSCRIBED = ("rl_hhi_rich5", "rl_mag_rich_dense", "rl_hhi_ddpo", "rl_hhi_ddpo_mattergen_t1000",
               "rl_heat_capacity_t1000", "rl_cond_ddpo")


def _jax_harness(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _recorder(calls: list):
    def record(argv):
        calls.append(list(argv))
        raise _Stop
    return record


@pytest.fixture
def jax_entry_points(monkeypatch):
    """JAX's ``main`` / ``gen_eval`` replaced by recorders that stop the
    harness, and JAX's ``tools/pretrain.py`` (loaded by file location) by a
    recorder that returns; the recorded argument lists."""
    calls = {"main": [], "gen_eval": [], "pretrain": []}
    for name in ("main", "gen_eval"):
        monkeypatch.setitem(sys.modules, name, types.SimpleNamespace(main=_recorder(calls[name])))
    spec_from_file = importlib.util.spec_from_file_location

    class PretrainStub(importlib.abc.Loader):
        def create_module(self, spec):
            return None

        def exec_module(self, module):
            module.main = calls["pretrain"].append

    def spec_from_file_location(name, location, *args, **kwargs):
        if str(location).endswith("tools/pretrain.py"):
            return importlib.machinery.ModuleSpec(name, PretrainStub())
        return spec_from_file(name, location, *args, **kwargs)

    monkeypatch.setattr(importlib.util, "spec_from_file_location", spec_from_file_location)
    return calls


@pytest.fixture
def port_entry_points(monkeypatch):
    calls = {"main": [], "gen_eval": [], "pretrain": []}
    monkeypatch.setattr(port_main, "main", _recorder(calls["main"]))
    monkeypatch.setattr(port_gen_eval, "main", _recorder(calls["gen_eval"]))
    monkeypatch.setattr(port_pretrain, "main", calls["pretrain"].append)
    return calls


# ---------------------------------------------------------------- (a), (b)

@pytest.mark.parametrize("n,seed", [(400, 0), (800, 1)])
def test_demo_corpus_is_byte_equal_to_jax(tmp_path, n, seed):
    _jax_harness("rl_demo").make_dataset(str(tmp_path / "jax.extxyz"), n=n, seed=seed)
    rl_demo.make_dataset(str(tmp_path / "port.extxyz"), n=n, seed=seed)
    assert filecmp.cmp(tmp_path / "jax.extxyz", tmp_path / "port.extxyz", shallow=False)
    if (n, seed) == (800, 1):
        assert filecmp.cmp(tmp_path / "port.extxyz", RESULTS / "dataset_conditional.extxyz",
                           shallow=False)


def test_conditional_batches_equal_jax():
    from matinvent_tpu.chem.structure import read_extxyz as jax_read_extxyz

    path = str(RESULTS / "dataset_conditional.extxyz")
    jax_batches = _jax_harness("conditional_demo").conditional_batches(
        jax_read_extxyz(path), 256, 8, np.random.default_rng(0))
    port_batches = conditional_demo.conditional_batches(
        read_extxyz(path), 256, 8, np.random.default_rng(0))
    for _ in range(3):
        (jb, jc), (pb, pc) = next(jax_batches), next(port_batches)
        np.testing.assert_array_equal(np.asarray(jb.atom_types), pb.atom_types.numpy())
        np.testing.assert_array_equal(np.asarray(jb.num_atoms), pb.num_atoms.numpy())
        np.testing.assert_array_equal(np.asarray(jb.frac_coords), pb.frac_coords.numpy())
        np.testing.assert_array_equal(np.asarray(jb.lattice), pb.lattice.numpy())
        np.testing.assert_array_equal(jc["density"], pc["density"])


# ---------------------------------------------------------------- (c)

def _both(jax_fn, port_fn, argv):
    with pytest.raises(_Stop):
        jax_fn(list(argv))
    with pytest.raises(_Stop):
        port_fn(list(argv))


@pytest.mark.parametrize("family,mode", [("diffcsp", "reward_weighted"), ("diffcsp", "ddpo"),
                                         ("mattergen", "reward_weighted"), ("mattergen", "ddpo")])
def test_rl_demo_hands_main_jaxs_overrides(tmp_path, jax_entry_points, port_entry_points,
                                           family, mode):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "params.msgpack").write_bytes(b"")  # an existing MatterGen checkpoint is reused
    argv = [f"out={tmp_path / 'out'}", f"family={family}", f"mode={mode}", f"ckpt={ckpt}",
            "iters=7"]
    _both(_jax_harness("rl_demo").main, rl_demo.main, argv)
    assert port_entry_points["main"] == jax_entry_points["main"] and \
        len(port_entry_points["main"]) == 1
    assert port_entry_points["pretrain"] == jax_entry_points["pretrain"]
    assert len(port_entry_points["pretrain"]) == (family == "diffcsp")


PREDICTOR_RUNS = [
    ["run=mag"], ["run=heatcap", "iters=5"], ["run=hhi", "timesteps=1000"],
    ["run=gapbulk"], ["run=gapbulk", "family=mattergen"],
    ["run=mag", "topk=0.25", "replay_sample=4", "div=off", "mode=ddpo", "ddpo_epochs=2",
     "seed=3", "expname=x", "num_atoms_file=experiments/data/corpus_r4_num_atoms.json",
     "+sample_cfg.filter.reference.energies_path=e.json", "max_atoms=20"],
]


@pytest.mark.parametrize("args", PREDICTOR_RUNS, ids=lambda a: "_".join(a)[:40])
def test_rl_predictor_runs_hand_main_jaxs_overrides(tmp_path, jax_entry_points,
                                                    port_entry_points, args):
    out = tmp_path / "out"
    for ckpt, name in (("pretrained_mattergen", "params.msgpack"),
                       ("pretrained_mattergen_t1000", "params.msgpack"),
                       ("pretrained", "state_dict.npz")):
        (out / ckpt).mkdir(parents=True)
        (out / ckpt / name).write_bytes(b"")
    (out / "dataset.extxyz").write_text("")
    _both(_jax_harness("rl_predictor_runs").main, rl_predictor_runs.main, [f"out={out}", *args])
    assert port_entry_points["main"] == jax_entry_points["main"] and \
        len(port_entry_points["main"]) == 1
    assert port_entry_points["pretrain"] == jax_entry_points["pretrain"] == []


@pytest.mark.parametrize("args", [[], ["hidden=128", "layers=4", "timesteps=100", "max_atoms=8"]])
def test_post_rl_gen_eval_hands_gen_eval_jaxs_overrides(tmp_path, jax_entry_points,
                                                        port_entry_points, args):
    argv = [f"out={tmp_path}", f"ckpt={RESULTS / 'rl_hhi_rich5/models/final'}", "name=hhi_rich5",
            f"corpus={ROOT / 'experiments/data/corpus_r5.extxyz'}",
            f"pretrain_gen={RESULTS / 'gen_eval_1024_r5'}", *args]
    _both(_jax_harness("post_rl_gen_eval").main, post_rl_gen_eval.main, argv)
    assert port_entry_points["gen_eval"] == jax_entry_points["gen_eval"] and \
        len(port_entry_points["gen_eval"]) == 1


# ---------------------------------------------------------------- (d), (e)

def test_conditional_summary_of_jaxs_rows_is_jaxs():
    record = json.loads((RESULTS / "conditional_demo_summary.json").read_text())
    _, dens = conditional_demo.corpus(str(RESULTS))
    cond_stats = (("density", float(dens.mean()), float(dens.std())),)
    assert conditional_demo.summarize(copy.deepcopy(record["results"]), dens, cond_stats) == record


@pytest.mark.parametrize("tag,dropout", cfg_ablation_r4.MODELS)
def test_cfg_ablation_summary_of_jaxs_rows_is_jaxs(tag, dropout):
    record = json.loads((RESULTS / "cfg_ablation_r4.json").read_text())
    want = record["models"][tag]
    assert cfg_ablation_r4.model_summary(copy.deepcopy(want["rows"]), dropout) == want
    assert list(cfg_ablation_r4.GAMMAS) == record["gammas"]


@pytest.mark.parametrize("side,generation", [("pretrain", "gen_eval_1024_r5"),
                                             ("post_rl", "gen_eval_1024_post_hhi_rich5")])
def test_score_extxyz_equals_jaxs_record(tmp_path, side, generation):
    record = json.loads((RESULTS / "post_rl_gen_eval_hhi_rich5.json").read_text())
    got = post_rl_gen_eval.score_extxyz(
        str(RESULTS / generation / "generated_crystals.extxyz"), "hhi", str(tmp_path), side, "cpu")
    assert got == record[side]["reward_stats"]


# ---------------------------------------------------------------- (f), recipes

def _targets(node) -> list:
    if isinstance(node, dict):
        return [k for k in node if k == "_target_"] + [t for v in node.values() for t in _targets(v)]
    if isinstance(node, list):
        return [t for v in node for t in _targets(v)]
    return []


@pytest.mark.parametrize("name", ARCHIVED)
def test_every_archived_run_is_a_recipe_that_resolves(name):
    cfg = recipe_from_hparams(ARCHIVE / name / "hparams.yaml")
    assert not _targets(cfg) and "results_dir" not in cfg
    if name != "rl_hhi_ddpo":
        assert RECIPES[name] == cfg
    assert mat_invent.SUITES[cfg["model"].get("class", "MatterGenSuite")]
    for prop in cfg["reward"]["prop_cfg"]:
        assert prop["calculator"].get("class", "Empirical") in mat_invent.CALCULATORS
    resolved = mat_invent.resolve(name, rl_epoch=3)
    assert resolved["rl_epoch"] == resolved["pipeline"]["rl_epoch"] == 3
    model_path = Path(resolved["model"]["model_path"])
    if name != "rl_hhi_mattergen_refscale":  # its checkpoint never entered the repository
        assert model_path.is_dir() and model_path.is_relative_to(ROOT)


def test_archive_number_and_the_transcribed_recipes():
    assert len(ARCHIVED) == 27
    assert set(TRANSCRIBED) <= set(ARCHIVED)
    # the variant and the default DiffCSP run have no archive and stay
    assert {"rl_hhi_rich5_opt_filter", "diffcsp_hhi"} <= set(RECIPES) - set(ARCHIVED)


def test_rl_hhi_ddpo_repair_samples_the_in_repository_checkpoint():
    """The archive's DDPO run sampled a copy of the DiffCSP checkpoint
    outside the repository; the recipe differs from it there alone, and
    the in-repository checkpoint has the archive's widths."""
    archived = recipe_from_hparams(ARCHIVE / "rl_hhi_ddpo" / "hparams.yaml")
    assert not archived["model"]["model_path"].startswith("experiments/")
    recipe = copy.deepcopy(RECIPES["rl_hhi_ddpo"])
    assert recipe["model"].pop("model_path") == "experiments/results/pretrained"
    archived["model"].pop("model_path")
    assert recipe == archived
    ckpt = read_flat_yaml(RESULTS / "pretrained" / "config.yaml")
    assert {k: ckpt[k] for k in ("hidden_dim", "num_layers", "timesteps")} == {
        k: archived["model"]["model_cfg"][k] for k in ("hidden_dim", "num_layers", "timesteps")}


def test_recipe_from_hparams_maps_classes_and_paths():
    cfg = recipe_from_hparams(ARCHIVE / "rl_gapbulk_rich" / "hparams.yaml")
    ref = cfg["pipeline"]["sample_cfg"]["filter"]["reference"]
    assert ref == {"structures_path": "experiments/data/corpus_r4.extxyz",
                   "energies_path": "experiments/data/corpus_r4_energies.json"}
    assert cfg["sample_cfg"]["filter"]["reference"] == ref
    assert [p["calculator"]["class"] for p in cfg["reward"]["prop_cfg"]] == [
        "PropertyPredictor", "PropertyPredictor"]
    assert RECIPES["rl_gap_bulk"]["model"]["class"] == "DiffCSPSuite"
    assert "class" not in RECIPES["rl_gapbulk_mg_divoff"]["model"]
    resolved = mat_invent.resolve("rl_gapbulk_rich")
    assert Path(resolved["pipeline"]["sample_cfg"]["filter"]["reference"]["structures_path"]).is_file()


# ---------------------------------------------------------------- (g)

def test_tiny_rl_demo_runs_on_the_cpu_and_writes_its_summary(tmp_path):
    # MatterGen: DiffCSP's discrete schedule samples no valid crystal at
    # T=20 (JAX's rl_demo runs it at T=1000)
    summary = rl_demo.main([
        f"out={tmp_path}", "family=mattergen", "iters=2", "n=64", "pretrain_steps=200",
        "pretrain_batch=16", "hidden=32", "layers=2", "timesteps=20", "batch=32", "accum=10",
        "epochs=1", "device=cpu"])
    written = json.loads((tmp_path / "summary.json").read_text())
    assert written == summary and summary["iterations"] == 2
    assert all(np.isfinite(summary["reward_curve"]))
    assert mattergen_config(tmp_path / "pretrained").hidden_dim == 32
    assert (tmp_path / "rl_hhi" / "models" / "final").is_dir()
