"""Run recipes of the port's RL entry point, as Python dicts.

``rl_hhi_rich5`` holds the values of the archived JAX run's resolved config
(``experiments/results/rl_hhi_rich5/hparams.yaml``) without its Hydra
``_target_`` keys: the h256/L6 start checkpoint, 64 samples from the
``corpus_r5`` histogram per iteration, the invalid filter, the HHI reward,
the diversity filter, replay, and the reward-weighted fine-tune. Paths of
the repository are relative to its root; the other paths are relative to
the run's output directory.

``rl_mag_rich_dense`` holds the values of the archived JAX run
``experiments/results/rl_mag_rich_dense/hparams.yaml``: the same loop from
the h256/L6 checkpoint ``pretrained_geneval_r4`` with the ``corpus_r4``
histogram, rewarded by the predicted magnetic density (``maxv`` 0.04).

``diffcsp_hhi`` is the JAX package's default run, ``configs/base.yaml``
with ``model/diffcsp.yaml``, ``pipeline/mat_invent.yaml`` and
``reward/hhi.yaml`` resolved (192 samples per iteration, the base sample
filter, the reward-weighted fine-tune), on the in-repo DiffCSP checkpoint
``experiments/results/pretrained``. ``rl_hhi_ddpo`` and
``rl_hhi_ddpo_mattergen_t1000`` hold the values of the archived JAX DDPO
runs' ``hparams.yaml`` (``experiments/results/<name>/``): 128 samples of at
most 8 atoms, ``sample_clip`` 30, ``finetune_mode: ddpo``, on the DiffCSP
checkpoint (lr 3e-6, one PPO epoch) and on
``experiments/results/pretrained_mattergen_t1000`` (lr 3e-5, two epochs).
A model section names its suite under ``class`` (the last component of the
YAML's ``_target_``; ``MatterGenSuite`` when absent).

``rl_heat_capacity_t1000`` holds the values of the archived JAX run
``experiments/results/rl_heat_capacity_t1000/hparams.yaml``: 128 samples of
at most 8 atoms from ``pretrained_mattergen_t1000`` (``matinvent_corpus``
histogram, ``sample_clip`` 30), the reward-weighted fine-tune (lr 6e-4,
``sigma`` 0.02, replay of 16), rewarded by the heat capacity of the
``MLIPBridge`` phonon worker. ``rl_cond_ddpo`` holds those of
``experiments/results/rl_cond_ddpo/hparams.yaml``: DDPO of the conditional
checkpoint ``pretrained_conditional_v2`` (density 4.18, guidance 0.5, 64
samples of at most 8 atoms, lr 3e-5, two PPO epochs), rewarded by the
density.

``REWARDS`` holds the reward sections of ``configs/reward/*.yaml`` whose
calculators the port runs (the entry point's ``--reward NAME``, Hydra's
``reward=NAME``): the empirical ones, the GNN property predictors,
SynScore, the MLIP bridge's heat capacity, published ALIGNN
(``band_gap_alignn``: ``model_dir`` or ``$ALIGNN_MODEL_DIR``) and the remote
DFT bridge (``dft``). A calculator's class is the last component of the YAML's
``_target_``, under the calculator's ``class`` key; without that key it is
``Empirical``. ``BASE_FILTER`` is the sample filter of
``configs/base.yaml`` (``OptFilter`` arguments), which the recipe variant
``rl_hhi_rich5_opt_filter`` sets, as ``--set
pipeline.sample_cfg.filter=<json>`` can.
"""
from __future__ import annotations

import copy

_SAMPLE = {"num_batches": 1, "max_num": 16, "filter": None}
_FINETUNE = {"batch_size": 16, "accum_steps": 25, "epochs": 3, "sigma": 0.1}


def _prop(name: str, cls: str, target, minv, maxv, root: str | None = None,
          weight: float | None = None, **calculator) -> dict:
    """One ``prop_cfg`` entry: property and task ``name``, computed by a
    calculator of class ``cls`` writing under ``rewards/<root or name>``."""
    calc = {"class": cls} if cls != "Empirical" else {}
    calc.update(root_dir=f"rewards/{root or name}", task=name, **calculator)
    out = {"name": name, "calculator": calc, "target": target, "minv": minv, "maxv": maxv}
    if weight is not None:
        out["weight"] = weight
    return out


def _section(*props: dict, threshold: float = 0.8, reduce: str | None = None) -> dict:
    out = {"root_dir": "rewards", "prop_cfg": list(props), "reward_threshold": threshold}
    if reduce is not None:
        out["reduce"] = reduce
    return out


_EMP, _PP = "Empirical", "PropertyPredictor"

REWARDS = {
    "hhi": _section(_prop("hhi", _EMP, "descending", 750, 3250)),
    "price": _section(_prop("price", _EMP, "descending", 0.0, 100.0)),
    "abundance": _section(_prop("abundance", _EMP, "ascending", 0.0, 100000.0)),
    "log_abundance": _section(_prop("log_abundance", _EMP, "ascending", -3.0, 5.0)),
    "mcia": _section(_prop("mcia", _EMP, "descending", 20.0, 400.0, substrate="Si")),
    "band_gap": _section(_prop("band_gap", _PP, 3.0, 0.0, 2.0, root="bandgap"), threshold=0.875),
    "bulk_modulus": _section(_prop("bulk_modulus", _PP, 300.0, 0.0, 250.0)),
    "dielectric": _section(
        _prop("total_dielectric_constant", _PP, "ascending", 35.0, 120.0), threshold=0.875),
    "figure_of_merit": _section(_prop("figure_of_merit", _PP, "ascending", 10.0, 250.0)),
    "fom_gap_dielectric": _section(
        _prop("figure_of_merit", _PP, "ascending", 10.0, 250.0, weight=0.8),
        _prop("band_gap", _PP, "ascending", 0.5, 3.5, root="bandgap", weight=0.1),
        _prop("total_dielectric_constant", _PP, "ascending", 25.0, 50.0, weight=0.1),
        reduce="weight"),
    "formation_energy": _section(
        _prop("formation_energy", _PP, "descending", -3.5, -1.0, root="form_e"), threshold=0.6),
    "gap_bulk": _section(
        _prop("band_gap", _PP, 3.0, 0.0, 2.0, root="bandgap", weight=0.5),
        _prop("bulk_modulus", _PP, 300.0, 0.0, 250.0, weight=0.5),
        reduce="weight"),
    "mag_den_hhi": _section(
        _prop("magnetic_density", _PP, "ascending", 0.0, 0.25),
        _prop("hhi", _EMP, "descending", 750, 3250),
        reduce="min"),
    "magnetic_density": _section(_prop("magnetic_density", _PP, "ascending", 0.0, 0.25)),
    "pugh_ratio": _section(_prop("pugh_ratio", _PP, "ascending", 1.5, 10.0)),
    "shear_modulus": _section(_prop("shear_modulus", _PP, 200.0, 0.0, 160.0), threshold=0.9),
    "syn_score": _section(_prop("syn_score", "SynScore", "ascending", 0.5, 1.0)),
    "vickers_hardness": _section(_prop("vickers_hardness", _PP, "ascending", 5.0, 40.0)),
    "young_modulus": _section(_prop("young_modulus", _PP, "ascending", 80.0, 480.0)),
    "heat_capacity": _section(
        _prop("heat_capacity", "MLIPBridge", "ascending", 0.25, 2.0, env_name=None, worker=5)),
    "band_gap_alignn": _section(
        _prop("band_gap", "ALIGNN", 3.0, 0.0, 2.0, root="bandgap", model_dir=None),
        threshold=0.875),
    "dft": _section(
        {"name": "dft_band_gap", "calculator": {"class": "DFTCalc", "root_dir": "rewards/dft_bandgap",
                                                "task": "band_gap", "max_node": 16},
         "target": 3.0, "minv": 0.0, "maxv": 2.0},
        threshold=0.875),
}

BASE_FILTER = {
    "metrics": ["validity", "novel", "unique", "stable"],
    "relax": False,
    "structure_matcher": "disordered",
}

RECIPES = {
    "rl_hhi_rich5": {
        "expname": "rl_hhi_rich5",
        "seed": 0,
        "rl_epoch": 60,
        "sample_cfg": dict(_SAMPLE),
        "eval_size": 16,
        "pipeline": {
            "rl_epoch": 60,
            "seed": 0,
            "save_dir": "./",
            "save_freq": 60,
            "sample_cfg": dict(_SAMPLE),
            "topk_ratio": 0.5,
            "replay": True,
            "replay_args": {"buffer_size": 100, "sample_size": 10, "reward_cutoff": 0.1},
            "div_filter": True,
            "df_args": {"tol": 3, "buff": 6},
            "finetune_cfg": dict(_FINETUNE),
        },
        "model": {
            "model_name": "mattergen_base",
            "seed": 0,
            "model_cfg": {"hidden_dim": 256, "num_layers": 6, "time_dim": 256, "timesteps": 1000},
            "sample_cfg": {
                "batch_size": 64,
                "num_batches": 1,
                "num_atoms_distribution": "corpus_r5",
                "max_atoms": 20,
                "diffusion_guidance_factor": 0.0,
                "num_atoms_distribution_file": "experiments/data/corpus_r5_num_atoms.json",
            },
            "finetune_cfg": {"batch_size": 16, "timesteps": 1000, "lr": 0.0001},
            "model_path": "experiments/results/pretrained_geneval_r5_r5_long_s120000_ema",
            "config_overrides": {"sample_clip": 30.0},
        },
        "reward": REWARDS["hhi"],
        "logger": {"save_dir": "./"},
    },
}

# keys that name files of the repository (skipped where absent)
REPO_PATHS = (
    ("model", "model_path"),
    ("model", "sample_cfg", "num_atoms_distribution_file"),
    ("pipeline", "sample_cfg", "filter", "reference", "structures_path"),
    ("pipeline", "sample_cfg", "filter", "reference", "energies_path"),
)

RECIPES["rl_hhi_rich5_opt_filter"] = copy.deepcopy(RECIPES["rl_hhi_rich5"])

_MAG = copy.deepcopy(RECIPES["rl_hhi_rich5"])
_MAG.update(expname="rl_mag_rich_dense", rl_epoch=120)
_MAG["pipeline"].update(rl_epoch=120, save_freq=120)
_MAG["model"]["sample_cfg"].update(
    num_atoms_distribution="corpus_r4",
    num_atoms_distribution_file="experiments/data/corpus_r4_num_atoms.json",
)
_MAG["model"]["model_path"] = "experiments/results/pretrained_geneval_r4"
_MAG["reward"] = _section(_prop("magnetic_density", _PP, "ascending", 0.0, 0.04))
RECIPES["rl_mag_rich_dense"] = _MAG
RECIPES["rl_hhi_rich5_opt_filter"]["pipeline"]["sample_cfg"]["filter"] = dict(BASE_FILTER)

_DDPO_PIPELINE = {
    "topk_ratio": 0.5,
    "replay": True,
    "replay_args": {"buffer_size": 100, "sample_size": 10, "reward_cutoff": 0.1},
    "div_filter": True,
    "df_args": {"tol": 3, "buff": 6},
    "finetune_cfg": dict(_FINETUNE),
    "finetune_mode": "ddpo",
}


def _ddpo(expname: str, rl_epoch: int, model: dict) -> dict:
    return {
        "expname": expname,
        "seed": 0,
        "rl_epoch": rl_epoch,
        "sample_cfg": dict(_SAMPLE),
        "eval_size": 16,
        "pipeline": {"rl_epoch": rl_epoch, "seed": 0, "save_dir": "./", "save_freq": rl_epoch,
                     "sample_cfg": dict(_SAMPLE), **copy.deepcopy(_DDPO_PIPELINE)},
        "model": model,
        "reward": copy.deepcopy(REWARDS["hhi"]),
        "logger": {"save_dir": "./"},
    }


RECIPES["rl_hhi_ddpo"] = _ddpo("rl_hhi", 40, {
    "class": "DiffCSPSuite",
    "model_name": "diffcsp",
    "seed": 0,
    "model_cfg": {"hidden_dim": 128, "num_layers": 4, "time_dim": 256, "timesteps": 1000},
    "sample_cfg": {"batch_size": 128, "num_batches": 1, "num_atoms_distribution": "mp_20",
                   "max_atoms": 8},
    "finetune_cfg": {"batch_size": 16, "timesteps": 1000, "lr": 3e-06, "ddpo_epochs": 1},
    "model_path": "experiments/results/pretrained",
    "config_overrides": {"sample_clip": 30.0},
})
RECIPES["rl_hhi_ddpo_mattergen_t1000"] = _ddpo("rl_hhi_ddpo_mattergen_t1000", 60, {
    "model_name": "mattergen_base",
    "seed": 0,
    "model_cfg": {"hidden_dim": 256, "num_layers": 6, "time_dim": 256, "timesteps": 1000},
    "sample_cfg": {"batch_size": 128, "num_batches": 1, "num_atoms_distribution": "mp_20",
                   "max_atoms": 8, "diffusion_guidance_factor": 0.0},
    "finetune_cfg": {"batch_size": 16, "timesteps": 1000, "lr": 3e-05, "ddpo_epochs": 2},
    "model_path": "experiments/results/pretrained_mattergen_t1000",
    "config_overrides": {"sample_clip": 30.0},
})

_BASE_SAMPLE = {"num_batches": 1, "max_num": 16, "filter": dict(BASE_FILTER)}
RECIPES["diffcsp_hhi"] = {
    "expname": "diffcsp_hhi",
    "seed": 0,
    "rl_epoch": 120,
    "sample_cfg": copy.deepcopy(_BASE_SAMPLE),
    "eval_size": 16,
    "pipeline": {
        "rl_epoch": 120,
        "seed": 0,
        "save_dir": "./",
        "save_freq": 100,
        "sample_cfg": copy.deepcopy(_BASE_SAMPLE),
        "topk_ratio": 0.5,
        "replay": True,
        "replay_args": {"buffer_size": 100, "sample_size": 10, "reward_cutoff": 0.1},
        "div_filter": True,
        "df_args": {"tol": 3, "buff": 6},
        "finetune_cfg": {"batch_size": 16, "accum_steps": 50, "epochs": 3, "sigma": 0.025},
    },
    "model": {
        "class": "DiffCSPSuite",
        "model_name": "diffcsp",
        "seed": 0,
        "model_cfg": {"hidden_dim": 128, "num_layers": 4, "time_dim": 256, "timesteps": 1000},
        "sample_cfg": {"batch_size": 192, "num_batches": 1, "num_atoms_distribution": "mp_20",
                       "max_atoms": 20},
        "finetune_cfg": {"batch_size": 16, "timesteps": 1000, "lr": 0.0001},
        "model_path": "experiments/results/pretrained",
    },
    "reward": copy.deepcopy(REWARDS["hhi"]),
    "logger": {"save_dir": "./"},
}

_HEAT = _ddpo("rl_heat_capacity_t1000", 120, {
    "model_name": "mattergen_base",
    "seed": 0,
    "model_cfg": {"hidden_dim": 256, "num_layers": 6, "time_dim": 256, "timesteps": 1000},
    "sample_cfg": {"batch_size": 128, "num_batches": 1,
                   "num_atoms_distribution": "matinvent_corpus", "max_atoms": 8,
                   "diffusion_guidance_factor": 0.0},
    "finetune_cfg": {"batch_size": 16, "timesteps": 1000, "lr": 0.0006},
    "model_path": "experiments/results/pretrained_mattergen_t1000",
    "config_overrides": {"sample_clip": 30.0},
})
_HEAT["pipeline"].pop("finetune_mode")
_HEAT["pipeline"]["replay_args"]["sample_size"] = 16
_HEAT["pipeline"]["finetune_cfg"].update(accum_steps=50, sigma=0.02)
_HEAT["reward"] = copy.deepcopy(REWARDS["heat_capacity"])
RECIPES["rl_heat_capacity_t1000"] = _HEAT

_COND_SAMPLE = {**_SAMPLE, "invalid_filter": True}
_COND = _ddpo("rl_cond_ddpo", 40, {
    "model_name": "mattergen_base",
    "seed": 0,
    "model_cfg": {"hidden_dim": 256, "num_layers": 6, "time_dim": 256, "timesteps": 1000},
    "sample_cfg": {"batch_size": 64, "num_batches": 1,
                   "num_atoms_distribution": "matinvent_corpus", "max_atoms": 8,
                   "diffusion_guidance_factor": 0.5,
                   "properties_to_condition_on": {"density": 4.18}},
    "finetune_cfg": {"batch_size": 16, "timesteps": 1000, "lr": 3e-05, "ddpo_epochs": 2},
    "model_path": "experiments/results/pretrained_conditional_v2",
})
_COND["sample_cfg"] = dict(_COND_SAMPLE)
_COND["pipeline"]["sample_cfg"] = dict(_COND_SAMPLE)
_COND["pipeline"]["finetune_cfg"]["sigma"] = 0.025
_COND["reward"] = _section(_prop("density", _EMP, 4.18, 0.0, 4.18), threshold=0.875)
RECIPES["rl_cond_ddpo"] = _COND
