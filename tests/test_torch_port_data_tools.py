"""The port's corpus motifs and data tools against the JAX package's, on
the CPU.

``chem/motifs.py`` draws the same structures for the same numpy
generator, and the reference-set, predictor-set and histogram tools write
byte-equal files for the same arguments. ``train_syn_score`` takes three
steps at 4 bags from JAX's initial weights and bootstrap columns (rebuilt
from its keys) and is held against the JAX tool's saved ensemble: its data
(compositions, labels, features, split, bootstrap tables) exactly, its
weights, with the standardization unfolded, within ``2 steps lr``: Adam's
first steps move each weight by about ``lr`` in the sign of its gradient,
and an entry whose gradient is at f32 noise level may move the other way
in the other package; all but 1% of the entries agree within ``lr / 100``.
"""
from __future__ import annotations

import filecmp
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from matinvent_tpu.chem import motifs as jax_motifs
from matinvent_tpu_torch.chem import motifs
from matinvent_tpu_torch.tools import (
    derive_num_atoms_hist,
    make_predictor_dataset,
    make_reference_dataset,
    train_syn_score,
)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))


def _jax_tool(name: str):
    import importlib

    return importlib.import_module(name)


def _same_structure(a, b):
    np.testing.assert_array_equal(a.species, b.species)
    np.testing.assert_array_equal(a.frac_coords, b.frac_coords)
    np.testing.assert_array_equal(a.lattice, b.lattice)


def test_motif_tables_and_pools_equal_jax():
    assert motifs.cation_pool() == jax_motifs.cation_pool()
    assert motifs.anion_pool() == jax_motifs.anion_pool()
    assert motifs.BASE_MOTIF_NAMES == jax_motifs.BASE_MOTIF_NAMES
    assert list(motifs.MOTIFS) == list(jax_motifs.MOTIFS)
    for k, (coords, split) in jax_motifs.MOTIFS.items():
        np.testing.assert_array_equal(motifs.MOTIFS[k][0], coords)
        assert motifs.MOTIFS[k][1] == split


@pytest.mark.parametrize("max_atoms", [6, 20])
def test_rich_structures_equal_jax_for_the_same_generator(max_atoms):
    ours, theirs = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(40):
        _same_structure(motifs.make_rich_structure(ours, max_atoms=max_atoms),
                        jax_motifs.make_rich_structure(theirs, max_atoms=max_atoms))
    assert ours.random() == theirs.random()  # the same number of draws


def _same_dirs(a: Path, b: Path):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        assert filecmp.cmp(a / n, b / n, shallow=False), n


@pytest.mark.parametrize("args", [["n=40", "name=plain"], ["n=60", "rich=1", "max_atoms=12", "seed=3"]],
                         ids=["plain", "rich"])
def test_make_reference_dataset_writes_jax_s_files(tmp_path, args):
    make_reference_dataset.main([f"out={tmp_path / 'port'}", *args])
    _jax_tool("make_reference_dataset").main([f"out={tmp_path / 'jax'}", *args])
    _same_dirs(tmp_path / "port", tmp_path / "jax")


def test_make_predictor_dataset_writes_jax_s_files(tmp_path):
    args = ["n=120", "seed=2", "max_atoms=10"]
    make_predictor_dataset.main([f"out={tmp_path / 'port'}", *args])
    _jax_tool("make_predictor_dataset").main([f"out={tmp_path / 'jax'}", *args])
    _same_dirs(tmp_path / "port", tmp_path / "jax")


def test_derive_num_atoms_hist_writes_jax_s_table(tmp_path):
    corpus = str(ROOT / "experiments" / "data" / "reference.extxyz")
    derive_num_atoms_hist.main([corpus, "ref", str(tmp_path / "port.json")])
    _jax_tool("derive_num_atoms_hist").main([corpus, "ref", str(tmp_path / "jax.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_train_syn_score_matches_the_jax_tool(tmp_path):
    n, steps, E, seed, lr = 400, 3, 4, 0, 3e-3
    jax_tool = _jax_tool("train_syn_score")
    jax_tool.main([f"out={tmp_path / 'jax.npz'}", f"n={n}", f"steps={steps}", f"n_models={E}",
                   f"seed={seed}", f"lr={lr}"])
    ref = dict(np.load(tmp_path / "jax.npz"))

    comps = train_syn_score.sample_compositions(50, 5)
    assert [c.reduced_formula for c in comps] == [
        c.reduced_formula for c in jax_tool.sample_compositions(50, 5)]
    data = train_syn_score.prepare(n, seed, E)
    # JAX's initial weights and per-step bootstrap columns, from its keys
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    init = {
        "w1": np.asarray(jax.random.normal(k1, (E, 90, 180)) * (1 / np.sqrt(90))),
        "b1": np.zeros((E, 180), np.float32),
        "w2": np.asarray(jax.random.normal(k2, (E, 180, 2)) * (1 / np.sqrt(180))),
        "b2": np.zeros((E, 2), np.float32),
    }
    key, cols = jax.random.PRNGKey(seed + 1), []
    for _ in range(steps):
        key, sk = jax.random.split(key)
        cols.append(np.asarray(jax.random.randint(sk, (E, 512), 0, data["boots"].shape[1])))
    import torch

    params = {k: torch.tensor(v, dtype=torch.float32) for k, v in init.items()}
    losses = train_syn_score.train_ensemble(params, data["Xtr"], data["ytr"], data["boots"],
                                            steps, lr, cols=cols)
    assert len(losses) == steps and losses[-1] < losses[0]
    ours = train_syn_score.fold(params, data["mu"], data["sd"])
    mu, sd = data["mu"], data["sd"]

    def unfold(a):
        w1 = a["w1"] * sd[None, :, None]
        return {"w1": w1, "b1": a["b1"] + np.einsum("d,edh->eh", mu / sd, w1),
                "w2": a["w2"], "b2": a["b2"]}

    ours_u, ref_u = unfold(ours), unfold(ref)
    worst, loose, total = 0.0, 0, 0
    for k in ref_u:
        d = np.abs(ours_u[k] - ref_u[k])
        worst = max(worst, float(d.max()))
        loose += int((d > lr / 100).sum())
        total += d.size
    assert worst <= 2 * steps * lr, worst
    assert loose <= 0.01 * total, (loose, total)
    acc, auc = train_syn_score.validate(ours, data["Xva_raw"], data["yva"], "cpu")
    assert 0.0 <= acc <= 1.0 and 0.0 <= auc <= 1.0


def test_train_syn_score_writes_an_ensemble_synscore_loads(tmp_path):
    from matinvent_tpu.rewards.calculators.syn_score import SynScore as JaxSynScore
    from matinvent_tpu_torch.chem.structure import Structure
    from matinvent_tpu_torch.rewards.calculators import SynScore

    out = tmp_path / "ens.npz"
    train_syn_score.main([f"out={out}", "n=300", "steps=4", "n_models=3", "device=cpu"])
    assert (tmp_path / "ens.meta.txt").exists()
    s = Structure.from_parameters([4.2] * 3, [90] * 3, [11, 17], np.array([[0, 0, 0], [0.5] * 3]))
    ours = SynScore(root_dir=str(tmp_path / "p"), model_path=str(out), device="cpu")
    theirs = JaxSynScore(root_dir=str(tmp_path / "j"), model_path=str(out))
    assert ours.trained and theirs.trained
    from matinvent_tpu.chem.structure import Structure as JaxStructure

    js = JaxStructure.from_parameters([4.2] * 3, [90] * 3, [11, 17], np.array([[0, 0, 0], [0.5] * 3]))
    np.testing.assert_allclose(ours.calc(([s], None)), theirs.calc(([js], None)), rtol=1e-5)
