"""The port's host side of the RL loop against the JAX package's, on the CPU.

Exact equality throughout: the chemistry tables, reduced formulas, charge
balance (the native search against the plain enumeration too), the invalid
filter's mask and the HHI and density rewards on the 2,000 structures of
``experiments/data/reference.extxyz``, on random garbage and on what an
untrained net samples; the long-term
memory, diversity filter, top-k and replay buffer over a scripted run with
tied rewards; the recipe against the archived run's ``hparams.yaml``; the
checkpoint layout against the JAX package's writer. Last, one tiny
iteration of the entry point on the CPU.
"""
from __future__ import annotations

import csv
import itertools
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import matinvent_tpu.chem.data as jdata
from matinvent_tpu.chem.composition import Composition as JaxComposition
from matinvent_tpu.chem.structure import Structure as JaxStructure, read_extxyz as jax_read_extxyz
from matinvent_tpu.chem.validity import cell_size_ok as jax_cell_ok
from matinvent_tpu.chem.validity import smact_valid as jax_smact
from matinvent_tpu.chem.validity import structure_validity as jax_structure_validity
from matinvent_tpu.memory.ltm import LongTimeMem as JaxLTM
from matinvent_tpu.memory.replay_buffer import ReplayBuffer as JaxReplay
from matinvent_tpu.models.batch import CrystalBatch as JaxBatch
from matinvent_tpu.models.mattergen.sample import NUM_ATOMS_DISTRIBUTIONS as JAX_DISTS
from matinvent_tpu.models.mattergen.sample import load_num_atoms_distributions as jax_load_dists
from matinvent_tpu.models.sample import batch_to_structures as jax_b2s
from matinvent_tpu.models.sample import collate_data_list as jax_collate
from matinvent_tpu.models.suite.mattergen import MatterGenSuite as JaxSuite
from matinvent_tpu.models.suite.mattergen_import import mattergen_state_dict_from_params
from matinvent_tpu.native import charge_balanced_native as jax_native
from matinvent_tpu.pipeline.filters import invalid_filter as jax_invalid_filter
from matinvent_tpu.rewards.calculators.empirical import Empirical as JaxEmpirical
from matinvent_tpu.rewards.reward import Reward as JaxReward
import matinvent_tpu_torch.chem.data as pdata
from matinvent_tpu_torch.chem.composition import Composition
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz
from matinvent_tpu_torch.chem.validity import (
    cell_size_ok,
    charge_balanced,
    charge_balanced_plain,
    smact_valid,
    structure_validity,
)
from matinvent_tpu_torch.memory.ltm import LongTimeMem
from matinvent_tpu_torch.memory.replay_buffer import ReplayBuffer
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.mattergen.diffusion import MatterGenConfig, MatterGenDiffusion
from matinvent_tpu_torch.models.mattergen.sample import (
    NUM_ATOMS_DISTRIBUTIONS,
    MatterGenSampler,
    load_num_atoms_distributions,
)
from matinvent_tpu_torch.models.sample import batch_to_structures, collate_data_list
from matinvent_tpu_torch.models.suite.mattergen import (
    MatterGenSuite,
    load_model,
    params_from_jax,
)
from matinvent_tpu_torch.pipeline import mat_invent
from matinvent_tpu_torch.pipeline.filters import invalid_filter
from matinvent_tpu_torch.recipes import RECIPES
from matinvent_tpu_torch.rewards.calculators.empirical import Empirical
from matinvent_tpu_torch.rewards.reward import Reward
from matinvent_tpu_torch.utils.config import read_flat_yaml

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments/data/reference.extxyz"
RUN = ROOT / "experiments/results/rl_hhi_rich5"
HIST = ROOT / "experiments/data/corpus_r5_num_atoms.json"


def _garbage(n: int, seed: int = 0):
    """Random crystals: any species (MASK-like 0 included), cells from
    degenerate to 30 A, atoms piled on one another."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 9))
        species = rng.integers(0, 101, k) if rng.uniform() < 0.2 else rng.integers(1, 101, k)
        scale = rng.choice([0.3, 3.0, 6.0, 30.0])
        lat = np.eye(3) * scale + rng.normal(size=(3, 3)) * scale * 0.3
        frac = rng.uniform(size=(k, 3))
        out.append((lat, species, frac))
    return out


def _both(items):
    return [Structure(*x) for x in items], [JaxStructure(*x) for x in items]


def test_chem_tables_equal_jax():
    assert pdata.SYMBOLS == jdata.SYMBOLS
    assert pdata.Z_BY_SYMBOL == jdata.Z_BY_SYMBOL
    for name in ("ELECTRONEGATIVITY", "OXIDATION_STATES", "METALS", "HHI_RESERVE"):
        assert getattr(pdata, name) == getattr(jdata, name), name
    pw, jw = pdata.ATOMIC_WEIGHTS, jdata.ATOMIC_WEIGHTS
    assert set(pw) == set(jw)
    assert all(pw[k] == jw[k] or (math.isnan(pw[k]) and math.isnan(jw[k])) for k in pw)


def test_validity_filter_and_rewards_equal_jax_on_reference_and_garbage(tmp_path):
    strucs = read_extxyz(str(REFERENCE))
    jstrucs = jax_read_extxyz(str(REFERENCE))
    assert len(strucs) == len(jstrucs) == 2000
    g, jg = _both(_garbage(300))
    # and what an untrained net samples
    model = MatterGenDiffusion(
        MatterGenConfig(hidden_dim=16, num_layers=1, time_dim=8, timesteps=3), device="cpu"
    )
    _, sampled = MatterGenSampler(batch_size=48, num_batches=1, seed=4).generate(model)
    s_items = [(x.lattice, x.species, x.frac_coords) for x in sampled]
    strucs += g + [Structure(*x) for x in s_items]
    jstrucs += jg + [JaxStructure(*x) for x in s_items]
    for s, j in zip(strucs, jstrucs):
        np.testing.assert_array_equal(s.frac_coords, j.frac_coords)
        assert s.composition.reduced_formula == j.composition.reduced_formula
        assert s.composition.formula == j.composition.formula
        assert structure_validity(s) == jax_structure_validity(j)
        assert cell_size_ok(s) == jax_cell_ok(j)
        if "X" not in j.composition.elements:
            assert smact_valid(s) == jax_smact(j)
    mask = invalid_filter(list(range(len(strucs))), strucs, return_mask=True)
    jmask = jax_invalid_filter(list(range(len(jstrucs))), jstrucs, return_mask=True)
    np.testing.assert_array_equal(mask, jmask)
    assert 0 < mask.sum() < len(mask)
    kept, _ = invalid_filter(list(range(len(strucs))), strucs)
    assert kept == [i for i in range(len(strucs)) if mask[i]]

    # the batched structural check agrees with the per-structure one
    batch = CrystalBatch.from_lists(
        [s.species for s in g], [s.frac_coords for s in g], [s.lattice for s in g], max_atoms=8
    )
    np.testing.assert_array_equal(
        structure_validity(batch).numpy(), [structure_validity(s) for s in g]
    )

    prop = dict(name="hhi", target="descending", minv=750, maxv=3250)
    dens = dict(name="density", target=4.0, minv=0.0, maxv=3.0)

    def rewards(pkg, calc, reward, props):
        return reward(str(tmp_path / pkg), [
            {**p, "calculator": calc(str(tmp_path / pkg / p["name"]), task=p["name"])}
            for p in props
        ], reward_threshold=0.8).scoring((strucs if pkg[0] == "p" else jstrucs, ""), "s")

    for props in ([prop], [prop, dens]):
        r, vals, failed = rewards("p", Empirical, Reward, props)
        jr, jvals, jfailed = rewards("j", JaxEmpirical, JaxReward, props)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(failed, jfailed)
        for k in jvals:
            np.testing.assert_array_equal(vals[k], jvals[k])
        assert (tmp_path / "p/hhi/s.txt").read_text() == (tmp_path / "j/hhi/s.txt").read_text()
    # the HHI reward alone: failures, and exact ties at both clip ends
    r, _, failed = rewards("p", Empirical, Reward, [prop])
    assert failed.any() and (r == 0).sum() > 10 and (r == 1).sum() > 10
    with pytest.raises(ValueError):
        Empirical(str(tmp_path / "x"), task="bandgap")


def test_native_charge_balance_against_plain_and_jax():
    rng = np.random.default_rng(1)
    syms = [s for s in pdata.OXIDATION_STATES if pdata.OXIDATION_STATES[s]]
    checked = 0
    for _ in range(3000):
        k = int(rng.integers(2, 5))
        el = list(rng.choice(syms, k, replace=False))
        counts = [int(c) for c in rng.integers(1, 7, k)]
        ox = [pdata.OXIDATION_STATES[s] for s in el]
        ens = [pdata.ELECTRONEGATIVITY.get(s) for s in el]
        want = charge_balanced_plain(ox, counts, ens)
        assert charge_balanced(ox, counts, ens) == want, (el, counts)
        assert jax_native(ox, counts, ens) == want
        checked += want
    assert checked > 100
    # a composition past the JAX fallback's 200,000-combination cap: the
    # native search still answers, as it does in the JAX package
    big = ("C", "N", "S", "Cl", "Br", "I", "Mn", "Os")
    assert math.prod(len(pdata.OXIDATION_STATES[s]) for s in big) > 200_000
    for counts in ((1, 2, 3, 1, 2, 1, 1, 1), (1, 1, 1, 1, 1, 1, 1, 1)):
        comp = {s: c for s, c in zip(big, counts)}
        want = smact_valid(Composition(comp))
        assert want == jax_smact(JaxComposition(comp))
        assert want == charge_balanced_plain(
            [pdata.OXIDATION_STATES[s] for s in sorted(big)],
            [comp[s] for s in sorted(big)],
            [pdata.ELECTRONEGATIVITY.get(s) for s in sorted(big)],
        )
    for formula in ("NaCl", "Fe2O3", "Fe3O4", "NaCl2", "LiFePO4", "CsAu", "OF2"):
        assert smact_valid(Composition(formula)) == jax_smact(JaxComposition(formula))


def _pool():
    """Structures over 60 binary compositions, two cells each."""
    rng = np.random.default_rng(2)
    cations, anions = (3, 11, 12, 19, 20, 26, 29, 30, 55, 56), (8, 9, 16, 17, 34, 35)
    out = []
    for c, a in itertools.product(cations, anions):
        for rep in range(2):
            species = np.array([c, a] * (rep + 1))
            out.append((np.eye(3) * 5.0, species, rng.uniform(size=(len(species), 3))))
    return out


def test_memory_topk_and_replay_equal_jax_with_tied_rewards(tmp_path):
    pool = _pool()
    ltm, jltm = LongTimeMem(), JaxLTM()
    rb, jrb = (ReplayBuffer(buffer_size=30, sample_size=10, reward_cutoff=0.1, seed=4),
               JaxReplay(buffer_size=30, sample_size=10, reward_cutoff=0.1, seed=4))
    rng = np.random.default_rng(5)
    sizes = []
    for step in range(8):
        idx = rng.choice(len(pool), 24)
        strucs, jstrucs = _both([pool[i] for i in idx])
        data = [f"s{step}_{i}" for i in range(len(idx))]
        # quantized rewards: many exact ties, as the clipped HHI reward gives
        rewards = rng.choice([0.0, 0.05, 0.25, 0.5, 1.0], len(idx))
        ltm.extend(strucs, rewards, step)
        jltm.extend(jstrucs, rewards, step)
        assert ltm.calc_metrics(0.4, num_candidate=3) == jltm.calc_metrics(0.4, num_candidate=3)
        assert ltm.unique_comps == list(jltm.unique_comps)
        new, pen, tol_n, buff_n = ltm.div_filter(strucs, rewards, tol=3, buff=6)
        jnew, jpen, jtol_n, jbuff_n = jltm.div_filter(jstrucs, rewards, tol=3, buff=6)
        np.testing.assert_array_equal(new, jnew)
        assert (pen, tol_n, buff_n) == (jpen, jtol_n, jbuff_n)
        top = np.argsort(new)[::-1][:20]
        rb.memory_purge([strucs[p] for p in pen])
        jrb.memory_purge([jstrucs[p] for p in jpen])
        d, r = rb.sample()
        jd, jr = jrb.sample()
        assert d == jd
        np.testing.assert_array_equal(r, jr)
        rb.extend([data[i] for i in top], [strucs[i] for i in top], new[top])
        jrb.extend([data[i] for i in top], [jstrucs[i] for i in top], new[top])
        assert [row["data"] for row in rb.buffer] == jrb.buffer["data"].tolist()
        np.testing.assert_array_equal(rb.rewards, jrb.buffer["reward"].values)
        sizes.append(len(rb))
    # the buffer outgrew the 16 rows below which numpy's quicksort is an
    # insertion sort, so the unstable order of tied rows was exercised
    assert len(ltm) == len(jltm) == 192 and max(sizes) > 16, sizes
    # the audit trail: same rows, columns and CIFs
    ltm.save(str(tmp_path / "p.csv"))
    jltm.save(str(tmp_path / "j.csv"))
    with open(tmp_path / "p.csv") as fp, open(tmp_path / "j.csv") as fj:
        prow, jrow = list(csv.reader(fp)), list(csv.reader(fj))
    assert prow[0] == jrow[0] and len(prow) == len(jrow)
    for a, b in zip(prow[1:], jrow[1:]):
        assert a[1:3] == b[1:3] and a[4:] == b[4:] and float(a[3]) == float(b[3])


def _strip(node):
    """A config tree without Hydra ``_target_`` keys, repository paths taken
    from ``experiments/`` on."""
    if isinstance(node, dict):
        return {k: _strip(v) for k, v in node.items() if k != "_target_"}
    if isinstance(node, list):
        return [_strip(v) for v in node]
    if isinstance(node, str) and "/experiments/" in node:
        return "experiments/" + node.split("/experiments/", 1)[1]
    return node


def test_recipe_matches_the_archived_hparams():
    hp = _strip(yaml.safe_load((RUN / "hparams.yaml").read_text()))
    hp.pop("results_dir")
    assert RECIPES["rl_hhi_rich5"] == hp
    cfg = mat_invent.resolve("rl_hhi_rich5", rl_epoch=2, overrides=["seed=3"])
    assert cfg["rl_epoch"] == cfg["pipeline"]["rl_epoch"] == 2 and cfg["seed"] == 3
    assert Path(cfg["model"]["model_path"]).is_dir()
    assert Path(cfg["model"]["sample_cfg"]["num_atoms_distribution_file"]).is_file()
    # the checkpoint's config is authoritative: time_dim 128, not the recipe's 256
    suite = MatterGenSuite(**cfg["model"], device="cpu")
    assert suite.model_config.time_dim == 128 and suite.model_config.sample_clip == 30.0
    sampler = suite.get_sampler()
    assert sampler.num_atoms_distribution == "corpus_r5" and sampler.size_buckets == 1


def test_histogram_file_and_generate_match_jax():
    load_num_atoms_distributions(str(HIST))
    jax_load_dists(str(HIST))
    np.testing.assert_array_equal(NUM_ATOMS_DISTRIBUTIONS["corpus_r5"], JAX_DISTS["corpus_r5"])
    model = MatterGenDiffusion(
        MatterGenConfig(hidden_dim=16, num_layers=1, time_dim=8, timesteps=3), device="cpu"
    )
    sampler = MatterGenSampler(batch_size=7, num_batches=1, num_atoms_distribution="corpus_r5",
                               num_atoms_distribution_file=str(HIST), seed=2)
    na = MatterGenSampler(num_atoms_distribution="corpus_r5", seed=2)._draw_num_atoms(7)
    data, strucs = sampler.generate(model)
    assert [d["num_atoms"] for d in data] == na.tolist()
    assert [s.num_atoms for s in strucs] == na.tolist()
    # the host conversions agree with JAX's both ways
    batch = collate_data_list(data, max_atoms=20)
    jbatch = jax_collate(data, max_atoms=20)
    for f in ("atom_types", "frac_coords", "lattice", "num_atoms"):
        np.testing.assert_array_equal(getattr(batch, f).numpy(), np.asarray(getattr(jbatch, f)))
    jdata_, jstrucs = jax_b2s(JaxBatch(*(np.asarray(getattr(batch, f)) for f in (
        "atom_types", "frac_coords", "lattice", "num_atoms"))))
    _, pstrucs = batch_to_structures(batch)
    for s, j in zip(pstrucs, jstrucs):
        np.testing.assert_array_equal(s.species, j.species)
        np.testing.assert_array_equal(s.lattice, j.lattice)


def test_save_model_round_trip_and_jax_layout(tmp_path):
    cfg = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8, sample_clip=12.5,
               condition_stats=(("dft_band_gap", 1.5, 0.7),), sigma_min=1e-5)
    jsuite = JaxSuite(model_name="mattergen_dft_band_gap", model_cfg=cfg)
    params = jsuite.diffusion.init_params(jax.random.PRNGKey(0), batch_size=2, max_atoms=4)
    jsuite.save_model(params, str(tmp_path / "jax"))
    suite = MatterGenSuite(model_name="mattergen_dft_band_gap", model_cfg=cfg, device="cpu")
    model = suite.load_model()
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    suite.save_model(model, tmp_path / "port")

    port_cfg = yaml.safe_load((tmp_path / "port/config.yaml").read_text())
    assert port_cfg == yaml.safe_load((tmp_path / "jax/config.yaml").read_text())
    assert read_flat_yaml(tmp_path / "port/config.yaml") == port_cfg
    with np.load(tmp_path / "port/state_dict.npz") as p, np.load(tmp_path / "jax/state_dict.npz") as j:
        ref = mattergen_state_dict_from_params(jax.device_get(params))
        assert sorted(p.files) == sorted(j.files) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(p[k], ref[k])
            np.testing.assert_array_equal(p[k], j[k])
    back = load_model(tmp_path / "port", device="cpu")
    assert back.config == model.config
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)


TINY = [
    "--set", "model.model_path=null", "--set", "model.model_cfg.hidden_dim=32",
    "--set", "model.model_cfg.num_layers=2", "--set", "model.model_cfg.time_dim=16",
    "--set", "model.model_cfg.timesteps=10", "--set", "model.model_cfg.sample_clip=15.0",
    "--set", "model.finetune_cfg.timesteps=10", "--set", "pipeline.finetune_cfg.accum_steps=5",
    "--set", "pipeline.finetune_cfg.epochs=1", "--set", "model.sample_cfg.batch_size=6",
    # an untrained model gives almost no valid samples: the filter is off,
    # as the JAX package's own end-to-end test runs it
    "--set", "pipeline.sample_cfg.invalid_filter=false",
]


def test_entry_point_runs_one_tiny_iteration_on_the_cpu(tmp_path):
    out = tmp_path / "run"
    pipe = mat_invent.main(["--recipe", "rl_hhi_rich5", "--rl-epoch", "1", "--out", str(out),
                            "--device", "cpu", *TINY])
    assert (out / "hparams.json").exists()
    for name in ("step_0000_valid.extxyz", "step_0000_eval.extxyz", "long_term_memory.csv"):
        assert (out / "samples" / name).exists(), name
    assert len(read_extxyz(str(out / "samples/step_0000_eval.extxyz"))) == 6
    with open(out / "metrics.csv") as fh, open(RUN / "metrics.csv") as ref:
        assert next(csv.reader(fh)) == next(csv.reader(ref))
    final = load_model(out / "models/final", device="cpu")
    for k, v in pipe.agent.state_dict().items():
        assert torch.equal(final.state_dict()[k], v), k
    # the agent moved away from the prior, which stayed frozen
    assert any(not torch.equal(v, pipe.prior.state_dict()[k])
               for k, v in pipe.agent.state_dict().items())
    assert not any(p.requires_grad for p in pipe.prior.parameters())
    # the iteration's top-k went into the replay buffer
    assert len(pipe.replay) > 0


@pytest.mark.parametrize("option", [
    # the ALIGNN calculator (ported last), on the model's device
    "reward.prop_cfg=[{\"name\": \"band_gap\", \"calculator\": {\"class\": \"ALIGNN\", "
    "\"root_dir\": \"rewards/band_gap\", \"task\": \"band_gap\"}, \"target\": 3.0, "
    "\"minv\": 0.0, \"maxv\": 2.0}]",
])
def test_options_not_ported_raise(tmp_path, option):
    """Every calculator class of the JAX package builds now: the ALIGNN
    case builds on the model's device (its checkpoints are resolved at
    scoring), and an unknown class still raises."""
    from matinvent_tpu_torch.rewards.calculators.alignn import ALIGNN

    key = option if option.startswith(("model.", "reward.")) else f"pipeline.{option}"
    cfg = mat_invent.resolve("rl_hhi_rich5", 1, [a for a in TINY if a != "--set"] + [key])
    pipe = mat_invent.build(cfg, str(tmp_path), device="cpu")
    calc = pipe.reward.prop_cfg[0]["calculator"]
    assert isinstance(calc, ALIGNN) and calc.device.type == "cpu"
    cfg["reward"]["prop_cfg"][0]["calculator"]["class"] = "NoSuchCalculator"
    with pytest.raises(NotImplementedError):
        mat_invent.build(cfg, str(tmp_path), device="cpu")


_RELAXER = '{"class": "SoftSphereRelaxer", "steps": 5, "max_atoms": 20}'


def _mlip(task):
    return ('reward.prop_cfg=[{"name": "%s", "calculator": {"class": "MLIPBridge", '
            '"root_dir": "rewards/%s", "task": "%s", "env_name": null, "worker": 1}, '
            '"target": "ascending", "minv": 0.0, "maxv": 2.0}]' % (task, task, task))


@pytest.mark.parametrize("option", [
    # the knn edge style
    "model.config_overrides={\"edge_style\": \"knn\"}",
    # MLIP relaxation before the filter, and the filter's own relaxer
    f"sample_cfg.mlip_opt={_RELAXER}",
    f"sample_cfg.filter={{\"metrics\": [\"validity\"], \"relax\": true, \"relaxer\": {_RELAXER}}}",
    # CSP mode
    "model.sample_cfg.target_compositions_dict=[{\"Fe\": 2, \"O\": 3}]",
    # the MLIP bridge's two tasks
    _mlip("heat_capacity"), _mlip("bulk_modulus"),
])
def test_ported_options_run_one_tiny_iteration(tmp_path, option):
    """The options the earlier slices refused build and run one tiny CPU
    iteration of the entry point."""
    key = option if option.startswith(("model.", "reward.")) else f"pipeline.{option}"
    out = tmp_path / "run"
    # two scored crystals keep the MLIP workers' Hessians few
    pipe = mat_invent.main(["--recipe", "rl_hhi_rich5", "--rl-epoch", "1", "--out", str(out),
                            "--device", "cpu", *TINY, "--set", "pipeline.sample_cfg.max_num=2",
                            "--set", key])
    with open(out / "metrics.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 1
    valid = read_extxyz(str(out / "samples/step_0000_valid.extxyz"))
    if "knn" in option:
        assert pipe.agent.config.edge_style == "knn"
        assert pipe.agent.decoder.edge_style == "knn"
    elif "mlip_opt" in option:
        assert isinstance(pipe.mlip_opt, mat_invent.SoftSphereRelaxer)
        assert pipe.mlip_opt.steps == 5
    elif "filter" in option:
        assert isinstance(pipe.filter.relaxer, mat_invent.SoftSphereRelaxer)
        assert "frac_validity" in rows[0]
    elif "target_compositions" in option:
        assert {s.composition.formula for s in valid} == {"Fe2O3"}
    else:
        task = "heat_capacity" if "heat" in option else "bulk_modulus"
        bridge = pipe.reward.prop_cfg[0]["calculator"]
        assert "backend: native soft-sphere" in bridge.last_stderr
        # one value per scored crystal (an untrained tiny model's cells are
        # degenerate: their values are NaN, and nothing is fine-tuned)
        values = np.atleast_1d(np.loadtxt(out / f"rewards/{task}/step_0000.txt"))
        assert values.shape == (2,)


def test_chip_smoke_validity_record_is_the_jax_record():
    import json

    import chip_smoke

    # the smoke reads its gate's record from the JAX package's file itself
    assert chip_smoke.VALIDITY_RECORD == ROOT / "experiments/results/validity_curve_r5.json"
    runs = json.loads(chip_smoke.VALIDITY_RECORD.read_text())["runs"]
    rec = next(r for r in runs if r["ckpt"] == chip_smoke.START.name)
    assert rec["n"] == chip_smoke.VALIDITY_BATCH
    assert {k: rec[k] for k in ("smact_fail", "structural_fail", "cell_fail", "all_ok")} == \
        {"smact_fail": 0.2988, "structural_fail": 0.0234, "cell_fail": 0.0, "all_ok": 0.6875}
