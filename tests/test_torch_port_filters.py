"""The port's sample filter, structure matcher, Niggli reduction, hull and
empirical rewards against the JAX package's, on the CPU.

Exact equality wherever both sides run the same float operations: Niggli
and primitive reduction bitwise, the matcher's features and masks for every
tier (native and plain), ``OptFilter`` / ``OptEval`` masks and metrics.
The hull goes through scipy's HiGHS on both sides (within 1e-9); the
rewards within 1e-12, NaN in the same places. Inputs: structures of
``experiments/data/reference.extxyz`` and the ``corpus_r5`` corpus, their
permuted, translated, supercell, perturbed, scaled and relabeled copies
(so that matches occur), and seeded random cells, skewed ones included.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from matinvent_tpu.chem import matcher as jmatcher
from matinvent_tpu.chem import niggli as jniggli
from matinvent_tpu.chem.ehull import ConvexHullReference as JaxHull
from matinvent_tpu.chem.ehull import PhaseEntry as JaxEntry
from matinvent_tpu.chem.ehull import stable_mask as jax_stable_mask
from matinvent_tpu.chem.structure import Structure as JaxStructure
from matinvent_tpu.pipeline import filters as jfilters
from matinvent_tpu.rewards.calculators import empirical as jemp
from matinvent_tpu_torch.chem import matcher as pmatcher
from matinvent_tpu_torch.chem import niggli as pniggli
from matinvent_tpu_torch.chem.ehull import ConvexHullReference, PhaseEntry, stable_mask
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz
from matinvent_tpu_torch.models.mattergen.diffusion import MatterGenConfig, MatterGenDiffusion
from matinvent_tpu_torch.models.mattergen.sample import MatterGenSampler
from matinvent_tpu_torch.pipeline import filters as pfilters
from matinvent_tpu_torch.recipes import BASE_FILTER, RECIPES, REWARDS
from matinvent_tpu_torch.rewards.calculators import empirical as pemp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = read_extxyz(str(ROOT / "experiments/data/reference.extxyz"))
ENERGIES = json.loads((ROOT / "experiments/data/corpus_r5_energies.json").read_text())


def corpus_head(n: int, tmp: Path) -> list[Structure]:
    """The first ``n`` structures of the corpus, read without the rest."""
    blocks = []
    with (ROOT / "experiments/data/corpus_r5.extxyz").open() as fh:
        while len(blocks) < n:
            k = int(next(fh))
            blocks.append([str(k), next(fh).rstrip("\n")] + [next(fh).rstrip("\n") for _ in range(k)])
    tmp.write_text("\n".join("\n".join(b) for b in blocks) + "\n")
    return read_extxyz(str(tmp))


def to_jax(s: Structure) -> JaxStructure:
    return JaxStructure(s.lattice, s.species, s.frac_coords)


def random_cells(rng, n: int, skew: bool) -> list[Structure]:
    """Random cells of 1-8 atoms; ``skew`` gives long, sheared lattices."""
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 9))
        lat = np.diag(rng.uniform(3.0, 7.0, 3)) + rng.normal(scale=0.6, size=(3, 3))
        if skew:
            lat[2] += rng.integers(-3, 4) * lat[0] + rng.integers(-3, 4) * lat[1]
            lat[1] += rng.integers(-2, 3) * lat[0]
        species = rng.choice([3, 8, 12, 14, 22, 26, 29, 34, 56], size=k)
        out.append(Structure(lat, species, rng.uniform(size=(k, 3))))
    return out


def variants(s: Structure, rng) -> list[Structure]:
    """Copies of ``s`` that the exact matchers should match: permuted sites,
    a translation, a 2x supercell, perturbed sites, a 5% larger cell, and one
    with its species relabeled (a match for the disordered tier only)."""
    n = s.num_atoms
    perm = rng.permutation(n)
    half = s.frac_coords / [2.0, 1.0, 1.0]
    cart = s.cart_coords + rng.normal(scale=0.02, size=(n, 3))
    relabel = {z: z2 for z, z2 in zip(np.unique(s.species), [11, 9, 17, 35, 53][:len(np.unique(s.species))])}
    return [
        Structure(s.lattice, s.species[perm], s.frac_coords[perm]),
        Structure(s.lattice, s.species, (s.frac_coords + rng.uniform(size=3)) % 1.0),
        Structure(s.lattice * [[2.0], [1.0], [1.0]], np.concatenate([s.species, s.species]),
                  np.concatenate([half, half + [0.5, 0.0, 0.0]])),
        Structure(s.lattice, s.species, (cart @ np.linalg.inv(s.lattice)) % 1.0),
        Structure(s.lattice * 1.05, s.species, s.frac_coords),
        Structure(s.lattice, [relabel[z] for z in s.species], s.frac_coords),
    ]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return corpus_head(40, tmp_path_factory.mktemp("corpus") / "head.extxyz")


@pytest.fixture(scope="module")
def match_set(corpus):
    """Structures of both files with their copies, and random cells."""
    rng = np.random.default_rng(7)
    base = REFERENCE[:3] + REFERENCE[500:502] + [s for s in corpus if s.num_atoms <= 8][:3]
    out = []
    for s in base:
        out += [s] + variants(s, rng)
    out += random_cells(rng, 6, skew=False) + random_cells(rng, 4, skew=True)
    return out


def assert_same(a, b, what=""):
    """Exact equality of nested tuples of str, numbers and arrays."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for x, y in zip(a, b):
            assert_same(x, y, what)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=what)
        assert a.dtype == np.asarray(b).dtype, what
    else:
        assert a == b, what


# ------------------------------------------------------------------ niggli


def test_niggli_and_primitive_reduce_bitwise_equal_jax(corpus):
    rng = np.random.default_rng(3)
    cells = random_cells(rng, 30, skew=False) + random_cells(rng, 30, skew=True)
    cells += REFERENCE[:20] + corpus[:10]
    # supercells (exact and jittered) exercise the primitive reduction
    for s in REFERENCE[:10]:
        for reps in ((2, 1, 1), (1, 2, 2)):
            grid = np.array([(i, j, k) for i in range(reps[0]) for j in range(reps[1])
                             for k in range(reps[2])], dtype=float)
            frac = ((s.frac_coords[None] + grid[:, None]) / reps).reshape(-1, 3)
            frac += rng.normal(scale=1e-3, size=frac.shape)
            cells.append(Structure(s.lattice * np.array(reps)[:, None],
                                   np.tile(s.species, len(grid)), frac % 1.0))
    reduced_primitive = 0
    for s in cells:
        j = to_jax(s)
        np.testing.assert_array_equal(pniggli.niggli_reduce_matrix(s.lattice),
                                      jniggli.niggli_reduce_matrix(j.lattice))
        for fn in ("niggli_reduce", "primitive_reduce"):
            p, q = getattr(pniggli, fn)(s), getattr(jniggli, fn)(j)
            np.testing.assert_array_equal(p.lattice, q.lattice)
            np.testing.assert_array_equal(p.species, q.species)
            np.testing.assert_array_equal(p.frac_coords, q.frac_coords)
        reduced_primitive += pniggli.primitive_reduce(s).num_atoms < s.num_atoms
    assert reduced_primitive >= 15  # the supercells did reduce


def test_sampler_niggli_reduction_reduces_the_generated_cells():
    model = MatterGenDiffusion(
        MatterGenConfig(hidden_dim=16, num_layers=1, time_dim=8, timesteps=3), device="cpu")
    kw = dict(batch_size=6, num_batches=1, max_atoms=8, seed=4)
    data, plain = MatterGenSampler(**kw).generate(model)
    data_n, reduced = MatterGenSampler(**kw, niggli_reduction=True).generate(model)
    for p, r, d, dn in zip(plain, reduced, data, data_n):
        q = jniggli.niggli_reduce(to_jax(p))
        np.testing.assert_array_equal(r.lattice, q.lattice)
        np.testing.assert_array_equal(r.frac_coords, q.frac_coords)
        np.testing.assert_array_equal(d["lattice"], dn["lattice"])  # the dicts stay raw


# ------------------------------------------------------------------ matcher


def _matchers(tier: str, native: bool):
    if tier == "fast":
        return pmatcher.StructureMatcher(), jmatcher.StructureMatcher()
    if tier == "ordered":
        return (pmatcher.OrderedStructureMatcher(pmatcher.ExactStructureMatcher(use_native=native)),
                jmatcher.OrderedStructureMatcher(jmatcher.ExactStructureMatcher(use_native=native)))
    return (
        pmatcher.DisorderedStructureMatcher(
            pmatcher.DisorderedExactStructureMatcher(use_native=native)),
        jmatcher.DisorderedStructureMatcher(
            jmatcher.DisorderedExactStructureMatcher(use_native=native)),
    )


@pytest.mark.parametrize("native", [True, False], ids=["native", "plain"])
@pytest.mark.parametrize("tier", ["fast", "ordered", "disordered"])
def test_matcher_features_and_masks_equal_jax(match_set, tier, native):
    pm, jm = _matchers(tier, native)
    jset = [to_jax(s) for s in match_set]
    pf, jf = pm.features(match_set), jm.features(jset)
    for a, b in zip(pf, jf):
        assert_same(a, b, tier)
    unique = pm.unique_mask(match_set, pf)
    np.testing.assert_array_equal(unique, jm.unique_mask(jset, jf))
    # the reference: every other base structure, so some copies are novel
    ref = match_set[:7] + match_set[14:21] + match_set[28:35]
    novel = pm.novel_mask(match_set, ref, pf)
    np.testing.assert_array_equal(novel, jm.novel_mask(jset, [to_jax(s) for s in ref], jf))
    # matches occur and are missed: the masks test something
    assert 0 < unique.sum() < len(match_set) and 0 < novel.sum() < len(match_set)


def test_exact_fit_native_equals_plain_and_jax_per_pair(match_set):
    """Pair by pair over the first base structure's copies and the random
    cells: the native search, its plain version and JAX's agree."""
    pairs = [(a, b) for a in match_set[:7] for b in match_set[:7] + match_set[-4:]]
    for cls in ("ExactStructureMatcher", "DisorderedExactStructureMatcher"):
        nat, pla = getattr(pmatcher, cls)(), getattr(pmatcher, cls)(use_native=False)
        jax_m = getattr(jmatcher, cls)(use_native=False)
        fits = [nat.fit(a, b) for a, b in pairs]
        assert fits == [pla.fit(a, b) for a, b in pairs]
        assert fits == [jax_m.fit(to_jax(a), to_jax(b)) for a, b in pairs]
        assert any(fits) and not all(fits)


def test_native_build_failure_raises_and_nothing_falls_back(monkeypatch):
    def broken(name):
        raise RuntimeError(f"g++ failed to build {name}")

    pmatcher._structure_fit_fn.cache_clear()
    monkeypatch.setattr(pmatcher, "build_host", broken)
    try:
        s = REFERENCE[0]
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            pmatcher.ExactStructureMatcher().fit(s, s)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            pmatcher.DisorderedStructureMatcher().unique_mask([s, s])
        assert pmatcher.ExactStructureMatcher(use_native=False).fit(s, s)
    finally:
        pmatcher._structure_fit_fn.cache_clear()


# ------------------------------------------------------------------ hull


def test_hull_energy_and_stable_mask_equal_jax(corpus):
    entries = list(ENERGIES.items())[::2]
    hull = ConvexHullReference([PhaseEntry.make(f, e) for f, e in entries])
    jhull = JaxHull([JaxEntry.make(f, e) for f, e in entries])
    assert hull.known_elements == jhull.known_elements
    strucs = corpus + REFERENCE[:40]
    rng = np.random.default_rng(5)
    energies = [s.num_atoms * rng.uniform(-3.0, 0.5) for s in strucs]
    energies[3] = float("nan")
    covered = 0
    for s, e in zip(strucs, energies):
        j = to_jax(s)
        h, jh = hull.hull_energy(s.composition), jhull.hull_energy(j.composition)
        assert np.isnan(h) == np.isnan(jh)
        covered += not np.isnan(h)
        if not np.isnan(h):
            assert abs(h - jh) <= 1e-9
            e_pa = e / s.num_atoms
            a = hull.energy_above_hull(s.composition, e_pa)
            b = jhull.energy_above_hull(j.composition, e_pa)
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-9
    assert covered >= 20
    mask = stable_mask(strucs, energies, hull, threshold=0.1)
    np.testing.assert_array_equal(
        mask, jax_stable_mask([to_jax(s) for s in strucs], energies, jhull, threshold=0.1))
    assert 0 < mask.sum() < len(strucs)


# ------------------------------------------------------------ OptFilter/Eval


def _reference_pair(corpus, with_energies: bool):
    structures = REFERENCE[:20] + corpus[:10]
    entries = list(ENERGIES.items()) if with_energies else None
    return (pfilters.ReferenceDataset(structures, entries),
            jfilters.ReferenceDataset([to_jax(s) for s in structures], entries))


@pytest.mark.parametrize("case", ["no_reference", "reference", "energies", "stable_skip"])
def test_opt_filter_and_opt_eval_equal_jax(match_set, corpus, case):
    kwargs = dict(metrics=["validity", "novel", "unique", "stable"], relax=False,
                  structure_matcher="disordered")
    if case != "no_reference":
        pref, jref = _reference_pair(corpus, with_energies=case == "energies")
        kwargs_p, kwargs_j = dict(kwargs, reference=pref), dict(kwargs, reference=jref)
    else:
        kwargs_p = kwargs_j = kwargs
    strucs = match_set + REFERENCE[:15]
    jstrucs = [to_jax(s) for s in strucs]
    rng = np.random.default_rng(11)
    energies = ([s.num_atoms * rng.uniform(-6.0, 0.0) for s in strucs]
                if case in ("energies", "stable_skip") else None)
    data = [dict(i=i) for i in range(len(strucs))]
    pf, jf = pfilters.OptFilter(**kwargs_p), jfilters.OptFilter(**kwargs_j)
    pd_, ps, pm = pf(data, strucs, energies)
    jd, js, jm = jf(data, jstrucs, energies)
    assert pm == jm and pd_ == jd and len(ps) == len(js)
    for a, b in zip(ps, js):
        np.testing.assert_array_equal(a.frac_coords, b.frac_coords)
    masks_p, _ = pf.compute_metrics(strucs, energies)
    masks_j, _ = jf.compute_metrics(jstrucs, energies)
    assert masks_p.keys() == masks_j.keys()
    for k in masks_p:
        np.testing.assert_array_equal(masks_p[k], masks_j[k])
    assert ("frac_stable" in pm) == (case == "energies")
    pe, pes = pfilters.OptEval(**{k: v for k, v in kwargs_p.items() if k != "metrics"})(strucs, energies)
    je, jes = jfilters.OptEval(**{k: v for k, v in kwargs_j.items() if k != "metrics"})(jstrucs, energies)
    assert pe == je and len(pes) == len(jes)
    assert 0 < len(pd_) < len(data) or case == "no_reference"


def test_synthesizable_and_relaxer_raise(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # the synthesizable screen is ported (tests/test_torch_port_rewards.py):
    # its SynScore runs on the CPU when asked, and like every device entry
    # point raises without a card otherwise
    screen = pfilters.OptFilter(metrics=["validity", "synthesizable"], relax=False, device="cpu")
    assert screen.syn_calculator.trained
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pfilters.OptFilter(metrics=["validity", "synthesizable"], relax=False)
    # the relaxer is ported (tests/test_torch_port_relax.py): the filter
    # takes it and relaxes before its metrics
    seen = []
    relaxing = pfilters.OptFilter(metrics=["validity"], device="cpu",
                                  relaxer=lambda s: (seen.extend(s) or s, None))
    strucs = REFERENCE[:3]
    relaxing(list(range(3)), strucs)
    assert seen == strucs
    with pytest.raises(ValueError):
        pfilters.OptFilter(metrics=["novelty"])
    assert pfilters.build_filter(None) is None
    with pytest.raises(TypeError):
        pfilters.build_filter("opt")


def test_reference_dataset_from_files_equals_jax(tmp_path):
    from matinvent_tpu_torch.chem.structure import save_extxyz

    path = tmp_path / "ref.extxyz"
    save_extxyz(REFERENCE[:25], str(path))
    energies = tmp_path / "e.json"
    energies.write_text(json.dumps(dict(list(ENERGIES.items())[:300])))
    p = pfilters.ReferenceDataset.from_files(str(path), str(energies))
    j = jfilters.ReferenceDataset.from_files(str(path), str(energies))
    assert p.known_elements == j.known_elements
    assert len(p.structures) == len(j.structures) == 25
    assert [e.energy_per_atom for e in p.hull.entries] == [e.energy_per_atom for e in j.hull.entries]
    f = pfilters.build_filter(dict(BASE_FILTER, reference=dict(
        structures_path=str(path), energies_path=str(energies))))
    assert len(f.reference.structures) == 25 and f.reference.hull is not None


# ------------------------------------------------------------------ rewards


@pytest.mark.parametrize("task", ["price", "abundance", "log_abundance", "mcia"])
def test_empirical_rewards_equal_jax(tmp_path, match_set, task):
    rng = np.random.default_rng(13)
    if task == "mcia":  # the ZSL search takes about 0.3 s per structure
        strucs = match_set[:3] + REFERENCE[40:42] + random_cells(rng, 2, skew=True)
    else:
        strucs = match_set[::2] + REFERENCE[:30] + random_cells(rng, 5, skew=True)
    # Po has neither a price nor an abundance: NaN
    strucs.append(Structure(np.eye(3) * 4.0, [84, 8], [[0, 0, 0], [0.5, 0.5, 0.5]]))
    p = pemp.Empirical(str(tmp_path / "p"), task).calc((strucs, ""), "x")
    j = jemp.Empirical(str(tmp_path / "j"), task).calc(([to_jax(s) for s in strucs], ""), "x")
    np.testing.assert_array_equal(np.isnan(p), np.isnan(j))
    ok = ~np.isnan(p)
    assert ok.sum() >= len(strucs) // 2 and (task == "mcia" or not ok.all())
    np.testing.assert_allclose(p[ok], j[ok], rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["Ge", "GaAs", "InP", "AlN", "GaN", "SiC", "SiO2", "Al2O3"])
def test_substrates_equal_jax(name):
    p, j = pemp.make_substrate(name), jemp.make_substrate(name)
    np.testing.assert_array_equal(p.lattice, j.lattice)
    np.testing.assert_array_equal(p.frac_coords, j.frac_coords)
    assert pemp.SUB_MILLERS.get(name) == jemp.SUB_MILLERS.get(name)


# ------------------------------------------------------------------ recipes


def _without_targets(node):
    if isinstance(node, dict):
        return {k: _without_targets(v) for k, v in node.items() if k != "_target_"}
    if isinstance(node, list):
        return [_without_targets(v) for v in node]
    return node


@pytest.mark.parametrize("name", ["hhi", "price", "abundance", "log_abundance", "mcia"])
def test_reward_sections_equal_the_configs(name):
    cfg = yaml.safe_load((ROOT / f"configs/reward/{name}.yaml").read_text())
    assert REWARDS[name] == _without_targets(cfg)


def test_base_filter_equals_the_config_and_the_variant_recipe():
    cfg = yaml.safe_load((ROOT / "configs/base.yaml").read_text())
    assert BASE_FILTER == _without_targets(cfg["sample_cfg"]["filter"])
    variant = RECIPES["rl_hhi_rich5_opt_filter"]
    assert variant["pipeline"]["sample_cfg"]["filter"] == BASE_FILTER
    plain = RECIPES["rl_hhi_rich5"]
    assert plain["pipeline"]["sample_cfg"]["filter"] is None
    assert {k: v for k, v in variant.items() if k != "pipeline"} == {
        k: v for k, v in plain.items() if k != "pipeline"}


def test_invalid_filter_in_worker_processes_equals_serial():
    strucs = REFERENCE[:60] + random_cells(np.random.default_rng(17), 10, skew=True)
    serial = pfilters.invalid_filter(strucs, strucs, return_mask=True)
    np.testing.assert_array_equal(
        pfilters.invalid_filter(strucs, strucs, return_mask=True, num_workers=2), serial)
    np.testing.assert_array_equal(
        jfilters.invalid_filter([to_jax(s) for s in strucs], [to_jax(s) for s in strucs],
                                return_mask=True), serial)
    assert 0 < serial.sum() < len(strucs)


@pytest.mark.slow
def test_opt_eval_of_the_archived_gen_eval_crystals_equals_jax():
    """The 1,024 crystals that ``gen_eval.py`` sampled from the
    ``rl_hhi_rich5`` start checkpoint (saved before its relaxation) against
    the 36,000-structure corpus, disordered matcher: the port's metrics
    equal JAX's (about 100 s; outside tier-1, run with ``-m slow``). The
    archived record (0.954 unique, 0.975 novel) was taken after relaxation.
    """
    crystals = str(ROOT / "experiments/results/gen_eval_1024_r5/generated_crystals.extxyz")
    corpus = [str(ROOT / "experiments/data/corpus_r5.extxyz"),
              str(ROOT / "experiments/data/corpus_r5_energies.json")]
    port, _ = pfilters.OptEval(structure_matcher="disordered", relax=False,
                               reference=pfilters.ReferenceDataset.from_files(*corpus))(
        read_extxyz(crystals))
    jax_metrics, _ = jfilters.OptEval(structure_matcher="disordered", relax=False,
                                      reference=jfilters.ReferenceDataset.from_files(*corpus))(
        [to_jax(s) for s in read_extxyz(crystals)])
    print(json.dumps(port))
    assert port == jax_metrics and set(port) == {"frac_validity", "frac_unique", "frac_novel"}
