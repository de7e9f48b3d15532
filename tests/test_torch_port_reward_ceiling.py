"""The port's reward-ceiling tool against the JAX package's
``tools/reward_ceiling.py``, on the CPU.

* ``design_space`` gives the same 21,840 structures (lattices, species,
  coordinates) and the same design records; the Dulong-Petit bound and the
  heat-capacity pick are equal exactly.
* On a fixed subset of 256 designs (every 85th), ``magnetic_density`` and
  ``gap_bulk`` through both tools' ``score_reward``: each property within
  2.4e-6 of its predictor's ``y_std``, each reward within that tolerance
  carried through the config's linear scaling and weights, the validity
  mask equal, and the summary's discrete fields equal (a differing best
  design only where JAX's own rewards tie within the tolerance).

* Heat capacity through the port's MLIP bridge on the CPU, on the 4
  designs of the pick with the smallest supercells (24-32 atoms, about 10 s
  in all: the pick's first designs take 144-atom supercells, about 8 s a
  design on one core), held against JAX's record design by design
  (``phonon_check.heat_against_jax``). The first 8 designs of the pick are
  held on the card (``chip_smoke.py`` phase ``reward_ceiling``) and all 300
  in ``experiments.tools_check``.
"""
from __future__ import annotations

import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))  # run as a script too (``write_heat_record``)

from matinvent_tpu.chem.validity import smact_valid as jax_smact_valid
from matinvent_tpu.chem.validity import structure_validity as jax_structure_validity
from matinvent_tpu.rewards.reward import Reward as JaxReward
from matinvent_tpu.utils.config import load_config as jax_load_config
from matinvent_tpu_torch.rewards.reward import Reward
from matinvent_tpu_torch.tools import reward_ceiling as port

torch.set_num_threads(1)

N_DESIGNS = 21840
SUBSET = np.arange(0, N_DESIGNS, 85)[:256]
PROP_TOL = 2.4e-6  # of each predictor's y_std


@pytest.fixture(scope="module")
def jtool():
    spec = importlib.util.spec_from_file_location(
        "jax_reward_ceiling", ROOT / "tools" / "reward_ceiling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def spaces(jtool):
    return port.design_space(), jtool.design_space()


def test_design_space_matches_jax(spaces):
    (ours, meta), (ref, ref_meta) = spaces
    assert len(ours) == len(ref) == N_DESIGNS
    assert meta == ref_meta
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.lattice, b.lattice)
        np.testing.assert_array_equal(a.species, b.species)
        np.testing.assert_array_equal(a.frac_coords, b.frac_coords)


def test_dulong_petit_bound_and_heat_capacity_pick_match_jax(jtool, spaces):
    (ours, _), (ref, _) = spaces
    bound = port.dulong_petit_cv(ours)
    np.testing.assert_array_equal(bound, jtool.dulong_petit_cv(ref))
    order = np.argsort(-bound)
    want = np.concatenate([order[:200], order[200:: max(len(order) // 100, 1)][:100]])
    pick = port.heat_capacity_pick(ours)
    np.testing.assert_array_equal(pick, want)
    assert len(pick) == 300 == len(set(pick.tolist()))


def _recording(monkeypatch, cls) -> list:
    """Every (rewards, properties, failed) ``cls.scoring`` returns."""
    seen = []
    real = cls.scoring

    def scoring(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        seen.append((self, out))
        return out

    monkeypatch.setattr(cls, "scoring", scoring)
    return seen


def _reward_tol(reward) -> float:
    """``PROP_TOL`` of each property's y_std through its linear scaling and
    weight (``reduce``: mean, or weight)."""
    terms = []
    for cfg in reward.prop_cfg:
        calc = cfg["calculator"]
        y_std = calc._model(calc.task).y_std
        w = float(cfg.get("weight", 1.0)) if reward.reduce == "weight" else 1.0 / len(reward.prop_cfg)
        terms.append(w * PROP_TOL * y_std / (float(cfg["maxv"]) - float(cfg["minv"])))
    return float(sum(terms))


@pytest.mark.parametrize("name", ["magnetic_density", "gap_bulk"])
def test_predictor_rewards_on_a_subset_match_jax(jtool, spaces, name, tmp_path, monkeypatch):
    (ours_all, meta_all), (ref_all, _) = spaces
    ours = [ours_all[i] for i in SUBSET]
    ref = [ref_all[i] for i in SUBSET]
    meta = [meta_all[i] for i in SUBSET]
    jax_seen = _recording(monkeypatch, JaxReward)
    port_seen = _recording(monkeypatch, Reward)
    monkeypatch.chdir(tmp_path)
    want = jtool.score_reward(name, ref, meta, workdir=str(tmp_path / "jax"))
    got = port.score_reward(name, ours, meta, str(tmp_path / "port"), device="cpu")
    assert os.getcwd() == str(tmp_path)
    (_, (j_r, j_p, j_f)), = jax_seen
    (reward, (p_r, p_p, p_f)), = port_seen

    # each property within PROP_TOL of its y_std, each reward within that carried
    assert set(p_p) == set(j_p)
    for cfg in reward.prop_cfg:
        calc = cfg["calculator"]
        tol = PROP_TOL * calc._model(calc.task).y_std
        err = np.abs(np.asarray(p_p[cfg["name"]], float) - np.asarray(j_p[cfg["name"]], float))
        assert err.max() <= tol, (cfg["name"], float(err.max()), tol)
    tol = _reward_tol(reward)
    np.testing.assert_array_equal(p_f, j_f)
    np.testing.assert_allclose(p_r, j_r, rtol=0, atol=tol)

    # the validity mask
    valid = port.valid_mask(ours)
    np.testing.assert_array_equal(
        valid, np.array([jax_smact_valid(s) and jax_structure_validity(s) for s in ref]))

    # the summary: the same keys, the discrete fields equal (a best design
    # may differ only where JAX's rewards tie), the statistics within the
    # tolerance and the 4-decimal rounding
    assert list(got) == list(want)
    for k in ("reward", "threshold", "n_scored", "n_valid"):
        assert got[k] == want[k], k
    j_r = np.asarray(j_r, float)
    index = {tuple(sorted(m.items())): i for i, m in enumerate(meta)}
    for k in ("best_design", "best_valid_design"):
        g = {f: v for f, v in got[k].items() if f != "reward"}
        w = {f: v for f, v in want[k].items() if f != "reward"}
        if g != w:
            gi, wi = index[tuple(sorted(g.items()))], index[tuple(sorted(w.items()))]
            assert abs(j_r[gi] - j_r[wi]) <= tol, (k, g, w)
        assert abs(got[k]["reward"] - want[k]["reward"]) <= tol + 1e-4, k
    for k in ("max", "p99", "p95", "max_valid"):
        assert abs(got[k] - want[k]) <= tol + 1e-4, (k, got[k], want[k])
    for k in ("frac_above_threshold", "frac_valid_above_threshold"):
        # a reward within tol of the threshold may fall either side
        near = int(np.sum(np.abs(j_r - want["threshold"]) <= tol))
        assert abs(got[k] - want[k]) <= near / len(SUBSET) + 1e-5, k
    assert set(got["best_props"]) == set(want["best_props"])


def test_reward_configs_resolve_to_the_ports_calculators_on_the_device(tmp_path, monkeypatch):
    """The tool builds each reward from ``configs/reward/<name>.yaml`` as the
    entry point does: the same sections and threshold, the port's classes,
    on the device asked for."""
    from matinvent_tpu_torch.rewards.calculators import PropertyPredictor
    from matinvent_tpu_torch.rewards.calculators.mlip import MLIPBridge

    monkeypatch.chdir(tmp_path)
    for name, cls in (("magnetic_density", PropertyPredictor), ("gap_bulk", PropertyPredictor),
                      ("heat_capacity", MLIPBridge)):
        ref = jax_load_config(str(port.CONFIG_DIR), "base", overrides=[f"reward={name}"])["reward"]
        reward, threshold = port.build_reward(name, "cpu")
        assert threshold == float(ref.get("reward_threshold", 0.8))
        assert [c["name"] for c in reward.prop_cfg] == [c["name"] for c in ref["prop_cfg"]]
        for c in reward.prop_cfg:
            assert isinstance(c["calculator"], cls) and c["calculator"].device.type == "cpu"


def test_heat_capacity_through_the_bridge_matches_jax_record(spaces, tmp_path, monkeypatch):
    """The bridge's heat capacities equal the direct chain's, each design
    within 1e-3 of JAX's or a flip named with its measurement, and the
    port's spectrum at JAX's equilibrated cell within 1e-3 of JAX's."""
    import json

    from matinvent_tpu_torch.chem import phonon
    from matinvent_tpu_torch.chem.structure import Structure
    from matinvent_tpu_torch.experiments.phonon_check import heat_against_jax

    (ours, _), _ = spaces
    pick = port.heat_capacity_pick(ours)
    record = json.loads(HEAT_RECORD.read_text())

    def supercell_atoms(i):
        sp = record["spectra"][i]
        s = Structure(species=list(ours[pick[i]].species), lattice=np.asarray(sp["lattice"]),
                      frac_coords=np.asarray(sp["frac_coords"]))
        return s.num_atoms * int(np.prod(phonon.choose_reps(s, 8.0, 160)))

    index = sorted(range(len(pick)), key=supercell_atoms)[:4]
    designs = [ours[pick[i]] for i in index]
    monkeypatch.chdir(tmp_path)
    reward, _ = port.build_reward("heat_capacity", "cpu")
    _, props, failed = port.score_all(reward, designs, "heat")
    assert not np.any(failed)
    got = heat_against_jax(designs, props["heat_capacity"], index, "cpu")
    print({k: v for k, v in got.items() if k != "designs"})
    assert got["bridge_equal"] == len(index)
    assert got["probe_gap_max"] <= 1e-3
    assert got["ok"], got["designs"]


HEAT_RECORD = ROOT / "matinvent_tpu_torch/experiments/results/reward_ceiling_heat_jax.json"
# the relative nudges of every cell for JAX's further runs: a few f32 ulps
# each way, the size of the rounding differences between the two packages
HEAT_NUDGES = (1e-6, -1e-6)


def jax_spectra(structures) -> list[dict]:
    """JAX's heat-capacity chain (``chem/phonon.gamma_heat_capacity``) run
    directly on ``structures`` as its MLIP worker reads them from the
    extxyz file, all in one relaxation batch as the worker takes them: per
    structure C_v, the count of modes above the 1e10 rad/s floor that C_v
    sums over, the supercell's mass, the equilibrated cell, and the scale
    search's grid index and golden-section decisions with their margins
    (as ``phonon.scale_search_steps`` reports the port's), replayed on
    the relaxed cell: the equilibrated coordinates, the cell as given in
    f32 (the relaxer leaves it unchanged at ``lr_cell`` 0)."""
    import tempfile

    import jax.numpy as jnp

    from matinvent_tpu.chem import phonon as jphonon
    from matinvent_tpu.chem.structure import read_extxyz, save_extxyz

    def search(s):
        fn = jphonon._strain_energy_fn(s.num_atoms)
        args = (jnp.asarray(s.frac_coords % 1.0, jnp.float32), jnp.asarray(s.lattice, jnp.float32),
                jnp.asarray(s.species, jnp.int32))

        def energies(scales):
            return np.asarray(fn(*args, jnp.asarray(scales, jnp.float32)), np.float64)

        scales = np.linspace(0.35, 2.2, 75)
        e = energies(scales)
        interior = np.where((e[1:-1] < e[:-2]) & (e[1:-1] <= e[2:]) & np.isfinite(e[1:-1]))[0] + 1
        if interior.size == 0:
            return None, []
        k = int(interior[np.argmin(np.abs(scales[interior] - 1.0))])
        lo, hi = scales[k - 1], scales[k + 1]
        gr = (np.sqrt(5.0) - 1.0) / 2.0
        steps = []
        for _ in range(12):
            m1, m2 = hi - gr * (hi - lo), lo + gr * (hi - lo)
            e1, e2 = energies([m1, m2])
            steps.append((bool(e1 < e2), float((e2 - e1) / max(abs(e1), abs(e2)))))
            hi, lo = (m2, lo) if e1 < e2 else (hi, m1)
        return k, steps

    with tempfile.TemporaryDirectory() as work:
        structures = read_extxyz(save_extxyz(structures, os.path.join(work, "pick.extxyz")))
    out = []
    for given, s in zip(structures, jphonon._equilibrate(structures, None)):
        sc = jphonon.supercell(s, jphonon.choose_reps(s, 8.0, 160))
        w = np.abs(jphonon.gamma_frequencies(sc))
        mass = float(np.sum(jphonon._MASSES_AMU[np.asarray(sc.species)]))
        relaxed = type(s)(species=list(s.species), frac_coords=s.frac_coords,
                          lattice=given.lattice.astype(np.float32).astype(float))
        out.append(dict(heat_capacity=jphonon.harmonic_heat_capacity(w, mass),
                        modes_above_floor=int(np.sum(w > 1e10)), supercell_mass_amu=mass,
                        lattice=s.lattice.tolist(), frac_coords=s.frac_coords.tolist(),
                        search=search(relaxed)))
    return out


def write_heat_record(path: Path = HEAT_RECORD) -> dict:
    """The JAX tool's heat-capacity scores of its 300-design pick, design by
    design, on the cells as given and on every cell scaled by ``1 + nudge``
    for each of ``HEAT_NUDGES`` (about 3 minutes a run on 8 cores): where
    they differ, JAX's own workflow (relaxation, scale search, modes at the
    frequency floor) turns f32 rounding into another value. Then, for the
    cells as given, ``jax_spectra``: its C_v must equal the tool's as the
    worker wrote it (6 decimals), so the floor modes and equilibrated cells
    recorded beside it are those of the tool's own values. The card run of
    ``matinvent_tpu_torch.experiments.tools_check`` is held against it."""
    import json
    import tempfile

    spec = importlib.util.spec_from_file_location("jax_reward_ceiling", ROOT / "tools" / "reward_ceiling.py")
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    structures, meta = jtool.design_space()
    seen = []
    real = JaxReward.scoring

    def scoring(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        seen.append(out)
        return out

    JaxReward.scoring = scoring
    try:
        with tempfile.TemporaryDirectory() as work:
            summary = jtool.score_reward("heat_capacity", structures, meta, workdir=work)
        for nudge in HEAT_NUDGES:
            nudged = [type(x)(x.lattice * (1.0 + nudge), x.species, x.frac_coords)
                      for x in structures]
            with tempfile.TemporaryDirectory() as work:
                jtool.score_reward("heat_capacity", nudged, meta, workdir=work)
    finally:
        JaxReward.scoring = real
    (rewards, props, failed), *nudged_runs = seen
    pick = port.heat_capacity_pick(structures)

    def values(v):
        return [None if np.isnan(x) else float(x) for x in np.asarray(v, float)]

    spectra = jax_spectra([structures[i] for i in pick])
    direct = np.array([float(f"{d.pop('heat_capacity'):.6f}") for d in spectra])
    np.testing.assert_array_equal(direct, np.asarray(props["heat_capacity"], float))
    record = dict(
        summary=summary,
        nudges=list(HEAT_NUDGES),
        designs=[meta[i] for i in pick],
        heat_capacity=values(props["heat_capacity"]),
        heat_capacity_nudged=[values(run[1]["heat_capacity"]) for run in nudged_runs],
        rewards=[float(v) for v in np.asarray(rewards, float)],
        failed=[bool(v) for v in failed],
        spectra=spectra,
    )
    path.write_text(json.dumps(record, indent=1) + "\n")
    return record


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_port_reward_ceiling.py
    write_heat_record()
