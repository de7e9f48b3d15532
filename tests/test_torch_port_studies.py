"""The port's generation-quality studies
(``matinvent_tpu_torch/experiments/{validity_fix_r5,validity_curve_r5,
type_temperature_ab_r5,validity_diagnosis_r5,reward_tail_density_r5,
phonon_ceiling_split_r5}.py``), its launch scripts and its environment
check, held against the JAX package's studies (``experiments/*.py``,
imported by path; only their functions are called, never a ``main``, which
writes into ``experiments/results/``) and records on the CPU.

``JAX_PLATFORMS=cpu python tests/test_torch_port_studies.py`` writes
``matinvent_tpu_torch/experiments/results/phonon_ceiling_split_jax.json``
anew: JAX's C_v of each design at 6 and 8 Å, as given and with the cell
nudged by 1 +- 1e-6, with the equilibrated cell and the modes above the
1e10 rad/s floor behind it (``study_check.phonon_against_jax`` holds the
card's cells against it). With ``tau TAU N`` it samples JAX's
``type_temperature_ab_r5`` at one tau and N crystals today on the CPU
(about 14 minutes for 512 on 8 cores) into
``matinvent_tpu_torch/experiments/results/studies/type_temperature_jax_today.json``.
"""
from __future__ import annotations

import ast
import importlib.util
import json
import os
import random
import stat
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # run as a script too (``write_phonon_record``)

from matinvent_tpu_torch.chem.phonon import MASSES_AMU, gamma_frequencies, harmonic_heat_capacity
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz
from matinvent_tpu_torch.experiments import (
    phonon_ceiling_split_r5,
    reward_tail_density_r5,
    study_check,
    type_temperature_ab_r5,
    validity_curve_r5,
    validity_diagnosis_r5,
    validity_fix_r5,
)
from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite

RESULTS = ROOT / "experiments/results"
STUDIES = ("validity_fix_r5", "validity_curve_r5", "type_temperature_ab_r5",
           "validity_diagnosis_r5", "reward_tail_density_r5", "phonon_ceiling_split_r5")
PORT = {m.__name__.rsplit(".", 1)[1]: m for m in (
    validity_fix_r5, validity_curve_r5, type_temperature_ab_r5, validity_diagnosis_r5,
    reward_tail_density_r5, phonon_ceiling_split_r5)}
CV_TOL = study_check.CV_TOL
REWARD_TOL = 1e-4


def _jax_study(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def generation():
    from matinvent_tpu.chem.structure import read_extxyz as jax_read

    path = str(RESULTS / "gen_eval_1024_r4/generated_crystals.extxyz")
    return jax_read(path), read_extxyz(path)


# ---------------------------------------------------------------- (a), (b)

@pytest.mark.parametrize("which", ["generated_r4", "pretrain_corpus"])
def test_diagnose_equals_jax_and_the_record(generation, which):
    jax_vd = _jax_study("validity_diagnosis_r5")
    record = json.loads((RESULTS / "validity_diagnosis_r5.json").read_text())[which]
    if which == "generated_r4":
        jax_strucs, strucs = generation
        tag = "generated_r4"
    else:
        from matinvent_tpu.chem.structure import read_extxyz as jax_read

        path = validity_diagnosis_r5.CORPUS
        assert path == str(ROOT / "experiments/data/corpus_r4.extxyz")
        jax_corpus = jax_read(path)
        random.seed(0)
        jax_strucs = random.sample(jax_corpus, 3000)
        strucs = validity_diagnosis_r5.corpus_sample(read_extxyz(path))
        tag = os.path.basename(path)
        assert [s.num_atoms for s in strucs] == [s.num_atoms for s in jax_strucs]
        np.testing.assert_array_equal(np.concatenate([s.frac_coords for s in strucs]),
                                      np.concatenate([s.frac_coords for s in jax_strucs]))
    ours = validity_diagnosis_r5.diagnose(strucs, tag)
    assert ours == jax_vd.diagnose(jax_strucs, tag)
    assert ours == record


def test_measure_validity_equals_jax(generation):
    jax_strucs, strucs = generation
    ours = validity_fix_r5.measure_validity(strucs)
    assert ours == _jax_study("validity_fix_r5").measure_validity(jax_strucs)
    assert list(ours) == ["smact_fail", "structural_fail", "cell_fail", "all_ok", "n"]
    assert ours["n"] == 1024


# ---------------------------------------------------------------- (c)

def test_tail_subsamples_follow_one_generator_in_jax_order():
    got = reward_tail_density_r5.subsample_indices(12000)
    rng = np.random.default_rng(0)
    assert list(got) == ["hhi", "magnetic_density", "gap_bulk", "heat_capacity"]
    assert got["hhi"] is None
    for name, sub in (("magnetic_density", 4000), ("gap_bulk", 4000), ("heat_capacity", 400)):
        np.testing.assert_array_equal(got[name], rng.choice(12000, sub, replace=False))
    assert reward_tail_density_r5.CONFIGS == _jax_study("reward_tail_density_r5").CONFIGS


def test_tail_hhi_over_the_corpus_equals_the_record():
    corpus = read_extxyz(reward_tail_density_r5.CORPUS)
    ours = reward_tail_density_r5.score("hhi", corpus, "cpu")
    rec = json.loads((RESULTS / "reward_tail_density_r5.json").read_text())["hhi"]
    assert list(ours) == list(rec)
    assert {k: v for k, v in ours.items() if k != "seconds"} == \
        {k: v for k, v in rec.items() if k != "seconds"}


@pytest.mark.parametrize("name", ["magnetic_density", "gap_bulk"])
def test_tail_predictor_rewards_equal_jax(name, tmp_path, monkeypatch):
    from matinvent_tpu.chem.structure import read_extxyz as jax_read
    from matinvent_tpu.utils.config import instantiate as jax_instantiate
    from matinvent_tpu.utils.config import load_config as jax_load_config
    from matinvent_tpu_torch.main import CONFIG_DIR
    from matinvent_tpu_torch.utils.config import instantiate, load_config

    idx = reward_tail_density_r5.subsample_indices(12000)[name][:32]
    corpus = read_extxyz(reward_tail_density_r5.CORPUS)
    jax_corpus = jax_read(str(reward_tail_density_r5.CORPUS))
    monkeypatch.chdir(tmp_path)
    port_reward = instantiate(load_config(CONFIG_DIR, "base", overrides=[f"reward={name}"])["reward"],
                              "cpu", "reward")
    jax_reward = jax_instantiate(jax_load_config(str(CONFIG_DIR), "base",
                                                 overrides=[f"reward={name}"])["reward"])
    ours, _, failed = port_reward.scoring(([corpus[i] for i in idx], None), label=name)
    theirs, _, jfailed = jax_reward.scoring(([jax_corpus[i] for i in idx], None), label=name)
    np.testing.assert_array_equal(failed, jfailed)
    np.testing.assert_allclose(ours, theirs, atol=REWARD_TOL, rtol=0)
    assert port_reward.threshold == jax_reward.threshold
    # the study's statistics of these 32 through its own scoring function
    stats = reward_tail_density_r5.score(name, [corpus[i] for i in idx], "cpu")
    r = np.asarray(theirs, float)[~np.asarray(jfailed, bool)]
    assert stats["n_scored"] == r.size
    assert abs(stats["mean"] - round(float(r.mean()), 4)) <= REWARD_TOL + 1e-4


# ---------------------------------------------------------------- (d)

def _jax_cell(jm, structure, min_length, cap, scales=(1.0,)):
    """JAX's chain of ``cv_at`` in its parts (the JAX study module ``jm``
    imports the phonon functions it uses): the equilibrated cell, the
    supercell, |omega|; C_v and the modes above the floor per scale."""
    e = jm._equilibrate([structure], None)[0]
    sc = jm.supercell(e, jm.choose_reps(e, min_length, cap))
    w = np.abs(jm.gamma_frequencies(sc))
    mass = float(np.sum(jm._MASSES_AMU[np.asarray(sc.species)]))
    return dict(eq=e, sc=sc, mass=mass,
                cv={s: jm.harmonic_heat_capacity(w * s, mass, 300.0) for s in scales},
                modes={s: int(np.sum(w * s > study_check.FLOOR)) for s in scales})


def _port_structure(s) -> Structure:
    return Structure(species=list(np.asarray(s.species)), frac_coords=np.asarray(s.frac_coords),
                     lattice=np.asarray(s.lattice))


def _port_spectrum(sc):
    w = np.abs(gamma_frequencies(sc, device="cpu"))
    return w, float(np.sum(MASSES_AMU[np.asarray(sc.species)]))


SCALES = (1.0, 0.5, 1.414)


@pytest.mark.parametrize("name", list(phonon_ceiling_split_r5.DESIGNS))
def test_cv_at_6A_against_jax_and_the_record(name):
    """C_v at 6 Å (and at frequency scales 0.5 and 1.414) against JAX's
    ``cv_at``, the same supercell atom count. Where the two differ beyond
    ``CV_TOL`` each part of the gap is measured on both sides and must
    account for it: the acoustic modes counted above the 1e10 rad/s floor
    on one side only (each adds k_B over the supercell's mass), and, where
    the relaxation left the symmetric start along another direction (the
    equilibrated cells apart), the port's spectrum at JAX's equilibrated
    cell. The literal gaps are printed (``-s``)."""
    torch.set_num_threads(4)
    jm = _jax_study("phonon_ceiling_split_r5")
    record = json.loads((RESULTS / "phonon_ceiling_split_r5.json").read_text())[name]
    rec6 = record["supercell_convergence"]["min_length_6"]
    jax_design = jm.DESIGNS[name]
    theirs = _jax_cell(jm, jax_design, 6.0, 80, SCALES)
    assert theirs["cv"][1.0] == jm.cv_at(jax_design, 6.0, 80)[0]
    assert round(theirs["cv"][1.0], 4) == rec6["cv"]  # JAX today gives its record

    design = phonon_ceiling_split_r5.DESIGNS[name]
    sc = phonon_ceiling_split_r5.equilibrated_supercell(design, 6.0, 80, "cpu")
    assert sc.num_atoms == theirs["sc"].num_atoms == rec6["supercell_atoms"]
    w, mass = _port_spectrum(sc)
    assert mass == theirs["mass"]
    unit = study_check.floor_mode_cv(mass)
    lattice_gap = float(np.abs(sc.lattice - theirs["sc"].lattice).max())
    frac_gap = float(np.abs((sc.frac_coords - theirs["sc"].frac_coords + 0.5) % 1.0 - 0.5).max())
    cells_equal = lattice_gap <= 1e-6 and frac_gap <= 1e-5
    if not cells_equal:
        w, _ = _port_spectrum(_port_structure(theirs["sc"]))
    for scale in SCALES:
        cv = harmonic_heat_capacity(w * scale, mass)
        n = int(np.sum(w * scale > study_check.FLOOR)) - theirs["modes"][scale]
        jax_cv = theirs["cv"][scale]
        where = "" if cells_equal else " at JAX's cell"
        print(f"{name} x{scale}: port{where} {cv:.6f} jax {jax_cv:.6f} gap {abs(cv - jax_cv):.2e}, "
              f"floor modes {n:+d}, cells {'equal' if cells_equal else 'apart'} "
              f"({lattice_gap:.1e}, {frac_gap:.1e})")
        assert abs(n) <= study_check.FLOOR_MODES_MAX
        assert abs(cv - jax_cv - n * unit) <= CV_TOL
        if scale == 1.0:
            assert abs(cv - n * unit - rec6["cv"]) <= CV_TOL
    if cells_equal:
        # cv_at itself: the same chain
        cv1, atoms = phonon_ceiling_split_r5.cv_at(design, 6.0, 80, device="cpu")
        assert atoms == sc.num_atoms
        assert cv1 == harmonic_heat_capacity(w, mass)


def test_dulong_petit_and_the_split_constants_equal_the_record():
    jm = _jax_study("phonon_ceiling_split_r5")
    record = json.loads((RESULTS / "phonon_ceiling_split_r5.json").read_text())
    for name, s in phonon_ceiling_split_r5.DESIGNS.items():
        assert phonon_ceiling_split_r5.dulong_petit_cv(s) == record[name]["dulong_petit_cv"]
        js = jm.DESIGNS[name]
        np.testing.assert_array_equal(s.lattice, js.lattice)
        np.testing.assert_array_equal(np.asarray(s.species), np.asarray(js.species))
        np.testing.assert_array_equal(s.frac_coords, js.frac_coords)
        assert [f"min_length_{ml:g}" for ml, _ in phonon_ceiling_split_r5.LADDER] == \
            list(record[name]["supercell_convergence"])
        assert [f"freq_scale_{fs:g}" for fs in phonon_ceiling_split_r5.FREQ_SCALES] == \
            list(record[name]["potential_split"])
    assert phonon_ceiling_split_r5.REWARD_MIN + phonon_ceiling_split_r5.THRESHOLD * (
        phonon_ceiling_split_r5.REWARD_MAX - phonon_ceiling_split_r5.REWARD_MIN) == \
        record["threshold_cv"]
    for cv in (0.1, 1.0, 1.6137, 2.5):
        assert phonon_ceiling_split_r5.reward_of(cv) == jm.reward_of(cv)


def test_phonon_reference_is_jax_today():
    """The committed JAX cells (``study_check.PHONON_JAX``) are JAX's on this
    CPU today: BeH2 at 6 Å recomputed, every cell's C_v equal to the
    record's at its 4 decimals."""
    ref = json.loads(study_check.PHONON_JAX.read_text())["cells"]
    record = json.loads((RESULTS / "phonon_ceiling_split_r5.json").read_text())
    for name, cells in ref.items():
        for key, cell in cells.items():
            assert round(cell["cv"], 4) == record[name]["supercell_convergence"][key]["cv"]
            assert cell["supercell_atoms"] == record[name]["supercell_convergence"][key]["supercell_atoms"]
    jm = _jax_study("phonon_ceiling_split_r5")
    now = _jax_cell(jm, jm.DESIGNS["BeH2_fluorite"], 6.0, 80)
    cell = ref["BeH2_fluorite"]["min_length_6"]
    assert now["cv"][1.0] == cell["cv"] and now["modes"][1.0] == cell["modes_above_floor"]
    np.testing.assert_array_equal(now["eq"].lattice, np.asarray(cell["lattice"]))


# ---------------------------------------------------------------- (e)

def _kv_defaults(path: Path) -> dict:
    """``kv.get(key, default)`` of a study's ``main``: the default's value,
    or, for a path, its last string (the file or directory name)."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "kv" and len(node.args) == 2):
            key, default = node.args
            if isinstance(default, ast.Constant):
                out[key.value] = default.value
            else:
                strings = [n.value for n in ast.walk(default)
                           if isinstance(n, ast.Constant) and isinstance(n.value, str)]
                out[key.value] = strings[-1]
    return out


@pytest.mark.parametrize("study", STUDIES)
def test_arguments_and_defaults_are_jax(study):
    theirs = _kv_defaults(ROOT / "experiments" / f"{study}.py")
    ours = _kv_defaults(Path(PORT[study].__file__))
    # the port's own: where it writes, and which parts to run
    extra = {"out"} | ({"rewards"} if study == "reward_tail_density_r5" else set())
    assert set(ours) == set(theirs) | extra
    assert {k: ours[k] for k in theirs} == theirs


# ---------------------------------------------------------------- (f)

TINY = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=10)


def _tiny_ckpt(path: Path, seed: int, **cfg) -> str:
    suite = MatterGenSuite(model_cfg=dict(TINY, **cfg), sample_cfg={"max_atoms": 20}, seed=seed,
                           device="cpu")
    suite.save_model(suite.load_model(), path)
    return str(path)


def _results_listing():
    return sorted((str(p.relative_to(RESULTS)), p.stat().st_mtime_ns)
                  for p in RESULTS.rglob("*"))


JAX_FIX_KEYS = ["tag", "weight_types", "weight_pos", "steps", "lr", "d3pm_kind", "scratch",
                "ema_decay", "corpus", "ckpt_in", "ckpt_out", "smact_fail", "structural_fail",
                "cell_fail", "all_ok", "n", "sample_seconds"]
JAX_CURVE_KEYS = ["ckpt", "smact_fail", "structural_fail", "cell_fail", "all_ok", "n",
                  "sample_seconds"]


def test_tiny_studies_end_to_end_write_under_out_only(tmp_path):
    torch.set_num_threads(2)
    before = _results_listing()
    a = _tiny_ckpt(tmp_path / "ckpt_a", 0)
    b = _tiny_ckpt(tmp_path / "ckpt_b", 1, d3pm_kind="absorbing")
    out = tmp_path / "out"
    small = str(ROOT / "experiments/data/reference.extxyz")

    # validity_fix: a 2-step warm start, then steps=0 reuses it
    trained = validity_fix_r5.main([f"out={out}", f"ckpt={a}", "tag=tiny", "steps=2",
                                    "batch_size=8", "sample_n=8", f"corpus={small}", "device=cpu"])
    ckpt = out / "pretrained_geneval_r5_tiny"
    assert (ckpt / "params.msgpack").is_file() and trained["ms_per_step"] > 0
    again = validity_fix_r5.main([f"out={out}", f"ckpt={a}", "tag=tiny", "steps=0",
                                  "sample_n=8", f"corpus={small}", "device=cpu"])
    data = json.loads((out / "validity_fix_r5.json").read_text())
    jax_keys = list(json.loads((RESULTS / "validity_fix_r5.json").read_text())["runs"][-1])
    assert jax_keys == JAX_FIX_KEYS
    assert [list(r) for r in data["runs"]] == [JAX_FIX_KEYS]  # one entry per tag
    assert data["runs"][0]["steps"] == 0 and again["ckpt_out"] is None
    assert trained["ckpt_out"] == "pretrained_geneval_r5_tiny"
    assert data["runs"][0]["n"] == 8 and data["runs"][0]["corpus"] == "reference.extxyz"
    # the reused checkpoint sampled: the same weights as the one trained
    assert MatterGenSuite(model_path=str(ckpt), device="cpu").load_model().config.weight_types == 4.0

    # validity_curve over two checkpoints, one sampler
    curve = validity_curve_r5.main([f"out={out}", f"ckpts={a},{b}", "sample_n=8", "device=cpu"])
    assert [r["ckpt"] for r in curve["runs"]] == ["ckpt_a", "ckpt_b"]
    assert all(list(r) == JAX_CURVE_KEYS for r in curve["runs"])
    assert json.loads((out / "validity_curve_r5.json").read_text()) == curve

    # type_temperature at two taus
    tt = type_temperature_ab_r5.main([f"out={out}", f"ckpt={a}", "taus=1.0,0.5", "sample_n=8",
                                      "device=cpu"])
    record = json.loads((RESULTS / "type_temperature_ab_r5.json").read_text())
    assert list(tt) == list(record)
    assert [list(e) for e in tt["sweep"]] == [list(e) for e in record["sweep"][:2]]
    assert [e["tau"] for e in tt["sweep"]] == [1.0, 0.5] and tt["sample_n"] == 8
    assert json.loads((out / "type_temperature_ab_r5.json").read_text()) == tt
    assert _results_listing() == before


# ---------------------------------------------------------------- (g)

def test_check_env_fails_without_cuda_and_names_it():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "matinvent_tpu_torch.tools.check_env"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "[FAIL] CUDA not available" in proc.stdout
    assert "[ok]   numpy" in proc.stdout


def _recorder(bin_dir: Path, log: Path) -> dict:
    bin_dir.mkdir()
    stub = bin_dir / "python"
    stub.write_text(f'#!/bin/bash\nprintf "%s\\n" "$@" > {log}\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    return dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}")


def _recorded(log: Path) -> list[str]:
    for _ in range(100):  # run_rl.sh launches in the background
        if log.exists() and log.read_text():
            return log.read_text().splitlines()
        time.sleep(0.05)
    raise AssertionError(f"{log} was not written")


@pytest.mark.parametrize("script,args", [
    ("run_rl.sh", ["myexp", "rl_epoch=3", "model.model_path=/x"]),
    ("run_rl.sh", []),
    ("gen_eval.sh", ["/ckpt", "/out"]),
    ("gen_eval.sh", ["/ckpt", "/out", "ref.extxyz", "ref_energies.json"]),
])
def test_launch_scripts_pass_jax_overrides(tmp_path, script, args):
    runs = {}
    for side, path, program in (("jax", ROOT / "scripts" / script, None),
                                ("port", ROOT / "matinvent_tpu_torch/scripts" / script,
                                 "matinvent_tpu_torch." + ("main" if script == "run_rl.sh"
                                                           else "gen_eval"))):
        work = tmp_path / side
        work.mkdir()
        log = tmp_path / f"{side}.args"
        env = _recorder(tmp_path / f"{side}_bin", log)
        proc = subprocess.run(["bash", str(path), *args], cwd=work, env=env,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        argv = _recorded(log)
        if program is None:
            assert argv[0] == ("main.py" if script == "run_rl.sh" else "gen_eval.py")
            runs[side] = argv[1:]
        else:
            assert argv[:2] == ["-m", program]
            runs[side] = argv[2:]
        if script == "run_rl.sh":
            assert (work / "logs").is_dir()
    assert runs["port"] == runs["jax"]


def write_phonon_record() -> None:
    """JAX's cells of the supercell ladder at 6 and 8 Å, on the CPU."""
    jm = _jax_study("phonon_ceiling_split_r5")
    from matinvent_tpu.chem.structure import Structure as JaxStructure

    cells = {}
    for name, s in jm.DESIGNS.items():
        cells[name] = {}
        for ml, cap in ((6.0, 80), (8.0, 160)):
            c = _jax_cell(jm, s, ml, cap)
            nudged = [jm.cv_at(JaxStructure(lattice=s.lattice * f, species=s.species,
                                            frac_coords=s.frac_coords), ml, cap)[0]
                      for f in (1 - 1e-6, 1 + 1e-6)]
            assert c["cv"][1.0] == jm.cv_at(s, ml, cap)[0]
            cells[name][f"min_length_{ml:g}"] = dict(
                cv=c["cv"][1.0], supercell_atoms=c["sc"].num_atoms,
                modes_above_floor=c["modes"][1.0], supercell_mass_amu=c["mass"],
                species=[int(z) for z in c["eq"].species], lattice=c["eq"].lattice.tolist(),
                frac_coords=c["eq"].frac_coords.tolist(), cv_nudged=nudged)
            print(name, ml, cells[name][f"min_length_{ml:g}"]["cv"], flush=True)
    study_check.PHONON_JAX.write_text(json.dumps(dict(
        source="experiments/phonon_ceiling_split_r5.py cv_at of the JAX package on the CPU, "
               "in its parts (tests/test_torch_port_studies.py write_phonon_record)",
        cells=cells), indent=1) + "\n")


def write_tau_today(tau: float, n: int) -> None:
    """JAX's ``type_temperature_ab_r5`` sample at one tau today, on the CPU
    (its sampler, seed 7, the corpus_r4 histogram, 4 buckets), into
    ``matinvent_tpu_torch/experiments/results/studies/type_temperature_jax_today.json``;
    JAX's ``main``, which writes into ``experiments/results/``, is not run."""
    from matinvent_tpu.chem.structure import read_extxyz as jax_read
    from matinvent_tpu.chem.validity import cell_size_ok, smact_valid, structure_validity
    from matinvent_tpu.models.mattergen.sample import MatterGenSampler
    from matinvent_tpu.models.sample import atom_dist_from_structures, register_atom_dist
    from matinvent_tpu.models.suite.mattergen import MatterGenSuite as JaxSuite

    register_atom_dist("corpus", atom_dist_from_structures(
        jax_read(str(ROOT / "experiments/data/corpus_r4.extxyz"))))
    diffusion, params = JaxSuite(model_path=str(RESULTS / "pretrained_geneval_r4"),
                                 config_overrides=dict(type_temperature=tau),
                                 sample_cfg={"max_atoms": 20}).load_model()
    sampler = MatterGenSampler(batch_size=n, num_batches=1, max_atoms=20,
                               num_atoms_distribution="corpus", size_buckets=4, seed=7)
    t0 = time.time()
    _, strucs = sampler.generate(model=(diffusion, params))
    c = {"smact_fail": 0, "structural_fail": 0, "cell_fail": 0, "all_ok": 0}
    for st in strucs:
        ok_s, ok_g, ok_c = smact_valid(st), structure_validity(st), cell_size_ok(st)
        c["smact_fail"] += not ok_s
        c["structural_fail"] += not ok_g
        c["cell_fail"] += not ok_c
        c["all_ok"] += ok_s and ok_g and ok_c
    entry = dict(tau=tau, n=len(strucs), **{k: round(v / len(strucs), 4) for k, v in c.items()},
                 distinct_compositions=len({st.composition.reduced_formula for st in strucs}),
                 seconds_cpu=round(time.time() - t0, 1))
    path = Path(study_check.__file__).parent / "results/studies/type_temperature_jax_today.json"
    data = json.loads(path.read_text()) if path.exists() else {
        "source": "JAX's type_temperature_ab_r5 sampler today on a CPU "
                  "(tests/test_torch_port_studies.py write_tau_today)", "sweep": []}
    data["sweep"] = [e for e in data["sweep"] if (e["tau"], e["n"]) != (tau, n)] + [entry]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=1) + "\n")
    print(json.dumps(entry), flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_port_studies.py [tau TAU N]
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["tau"]:
        write_tau_today(float(sys.argv[2]), int(sys.argv[3]))
    else:
        write_phonon_record()
