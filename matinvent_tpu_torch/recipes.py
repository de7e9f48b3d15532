"""Run recipes of the port's RL entry point, as Python dicts.

Every archived JAX run (``experiments/results/<name>/hparams.yaml``, 27 of
them) is a recipe under its name: ``recipe_from_hparams`` reads its
resolved config with the port's YAML reader, drops the Hydra ``_target_``
keys (a model section names its suite under ``class``, ``MatterGenSuite``
when absent; a calculator its class, ``Empirical`` when absent, the last
component of the ``_target_``) and ``results_dir``, and takes the paths of
the archive's checkout (``REPO_PATHS``) from ``experiments/`` on. Paths of
the repository are relative to its root; the other paths are relative to
the run's output directory. ``rl_hhi_ddpo``'s archive names a DiffCSP
checkpoint outside the repository (``/tmp/...``); its recipe samples the
in-repository ``experiments/results/pretrained``, of the same widths.
``rl_hhi_mattergen_refscale``'s checkpoint is outside the repository too
and has no in-repository copy: that recipe resolves but cannot run.

``diffcsp_hhi`` is the JAX package's default run, ``configs/base.yaml``
with ``model/diffcsp.yaml``, ``pipeline/mat_invent.yaml`` and
``reward/hhi.yaml`` resolved (192 samples per iteration, the base sample
filter, the reward-weighted fine-tune), on the in-repo DiffCSP checkpoint
``experiments/results/pretrained``.

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
from pathlib import Path

from matinvent_tpu_torch.utils.yaml_io import read_yaml


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

# keys that name files of the repository (skipped where absent)
REPO_PATHS = (
    ("model", "model_path"),
    ("model", "sample_cfg", "num_atoms_distribution_file"),
    ("pipeline", "sample_cfg", "filter", "reference", "structures_path"),
    ("pipeline", "sample_cfg", "filter", "reference", "energies_path"),
    ("sample_cfg", "filter", "reference", "structures_path"),
    ("sample_cfg", "filter", "reference", "energies_path"),
)


# a ``_target_``'s class where the port builds it by default: no ``class`` key
_DEFAULT_CLASS = {"model": "MatterGenSuite", "calculator": "Empirical"}


def _from_targets(node, key: str | None = None):
    """A config tree with each ``_target_`` dropped, a model's or a
    calculator's class kept under ``class`` where it is not the default."""
    if isinstance(node, list):
        return [_from_targets(v, key) for v in node]
    if not isinstance(node, dict):
        return node
    out = {}
    for k, v in node.items():
        if k != "_target_":
            out[k] = _from_targets(v, k)
        elif key in _DEFAULT_CLASS and v.rsplit(".", 1)[-1] != _DEFAULT_CLASS[key]:
            out["class"] = v.rsplit(".", 1)[-1]
    return out


def recipe_from_hparams(path) -> dict:
    """The recipe of an archived JAX run's resolved config
    (``experiments/results/<name>/hparams.yaml``): its values without the
    Hydra ``_target_`` keys (a model's or calculator's class under
    ``class``, as ``REWARDS`` has it) and without ``results_dir`` (the run's
    ``--out`` takes its place); each path of ``REPO_PATHS`` that lies in
    the archive's checkout is taken from its ``experiments/`` on, others
    are kept as they are."""
    cfg = _from_targets(read_yaml(path))
    cfg.pop("results_dir", None)
    for keys in REPO_PATHS:
        node = cfg
        for k in keys[:-1]:
            node = node.get(k) if isinstance(node, dict) else None
        value = node.get(keys[-1]) if isinstance(node, dict) else None
        if isinstance(value, str) and "/experiments/" in value:
            node[keys[-1]] = "experiments/" + value.split("/experiments/", 1)[1]
    return cfg


ARCHIVE = Path(__file__).resolve().parents[1] / "experiments" / "results"
# every archived run, under its directory's name
RECIPES = {p.parent.name: recipe_from_hparams(p) for p in sorted(ARCHIVE.glob("*/hparams.yaml"))}
# the archive's DDPO run sampled a copy of the DiffCSP checkpoint outside the
# repository; the in-repository one has its widths
if "rl_hhi_ddpo" in RECIPES:
    RECIPES["rl_hhi_ddpo"]["model"]["model_path"] = "experiments/results/pretrained"
if "rl_hhi_rich5" in RECIPES:
    RECIPES["rl_hhi_rich5_opt_filter"] = copy.deepcopy(RECIPES["rl_hhi_rich5"])
    RECIPES["rl_hhi_rich5_opt_filter"]["pipeline"]["sample_cfg"]["filter"] = dict(BASE_FILTER)

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
