"""The port's config engine against the JAX package's, on the CPU.

The YAML reader equals ``yaml.safe_load`` on every config under
``configs/`` and every archived ``hparams.yaml``, and on the scalar forms
where YAML 1.1 and intuition part ways; ``load_config`` equals JAX's
exactly (dict equality after resolution) over a grid of overrides;
``save_config`` writes what ``yaml.safe_load`` reads back to the same
dict; every reward config instantiates on the CPU except the two whose
calculators are not ported, which raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
import os
from pathlib import Path

import pytest
import yaml

from matinvent_tpu.utils import config as jax_config
from matinvent_tpu_torch.utils import config
from matinvent_tpu_torch.utils.yaml_io import dump_yaml, load_yaml, read_yaml

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
YAML_FILES = sorted(CONFIGS.rglob("*.yaml")) + sorted(
    (ROOT / "experiments" / "results").rglob("hparams.yaml"))
REWARDS = sorted(p.stem for p in (CONFIGS / "reward").glob("*.yaml"))
# the reward groups whose calculators the port added last: ALIGNN (on the
# device, its checkpoints resolved at scoring) and the DFT bridge (host)
LATE_PORTS = {
    "band_gap_alignn": "matinvent_tpu_torch.rewards.calculators.alignn.calc.ALIGNN",
    "dft": "matinvent_tpu_torch.rewards.calculators.dft.calc.DFTCalc",
}


def test_the_yaml_set_is_the_repositorys():
    assert len(YAML_FILES) == 58


@pytest.mark.parametrize("path", YAML_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_reader_equals_safe_load(path):
    assert read_yaml(path) == yaml.safe_load(path.read_text())


SCALARS = [
    "1e-4", "1.0e-05", "1.0e5", "-1.5E+3", ".5", "+.inf", "-.inf", "yes", "No", "on", "OFF",
    "~", "", "null", "017", "0x1F", "0b101", "1_000", "3:25", "+1", "-0", "a b", "x # c",
    "'it''s'", '"a\\tb\\u00e9"', "[a, 1, [2, null]]", "{k: v, j: [1, 2], n: {}}", "[]", "{}",
    "a: b", "${calc:'${eval_size} * 12'}", "http://x", "- a\n- b: 1\n  c: [2]",
    "k:\n- 1\n- - 2\n  - 3\nm: {}\n",
]


@pytest.mark.parametrize("text", SCALARS)
def test_reader_resolves_scalars_and_flows_as_yaml_11(text):
    ref, ours = yaml.safe_load(text), load_yaml(text)
    assert type(ours) is type(ref)
    if isinstance(ref, float) and math.isnan(ref):
        assert math.isnan(ours)
    else:
        assert ours == ref


@pytest.mark.parametrize("text", ["k: >\n  a", "a: &x 1", "b: *x", "t: !!str 1", "d: 2001-12-14"])
def test_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        load_yaml(text)


@pytest.mark.parametrize("text", [
    "k: |\n  a", "k: |-\n  a\n\n", "k: |+\n  a\n\nb: 1\n", "- |\n  #!/bin/sh\n\n  x # y\n- z\n",
    "k: 'a\n\n  b c\n\n  '\n", "- 'it''s\n\n  x'\n",
])
def test_reader_reads_literal_blocks_and_multiline_quotes_as_safe_load(text):
    assert load_yaml(text) == yaml.safe_load(text)


def test_dump_round_trips_through_safe_load():
    odd = ["1e-4", "yes", "", " lead", "a: b", "#x", "x #y", "1.0", "null", "it's", "tab\there",
           "new\nline", "ü", "${calc:'${a} * 2'}", "-", "?", "017", "[x]"]
    tree = {"s": odd, "f": [1e-05, 1e16, -0.0, 3.0, float("inf")], "i": [0, -7, 10**12],
            "b": [True, False, None], "nested": [{"a": [], "b": {}}, [[1, 2], []]],
            5: "int key", "e": {}}
    assert yaml.safe_load(dump_yaml(tree)) == tree
    for s in odd:
        assert yaml.safe_load(dump_yaml({s or "k": s})) == {s or "k": s}


GRID = (
    [[]]
    + [[f"model={p.stem}"] for p in sorted((CONFIGS / "model").glob("*.yaml"))]
    + [[f"reward={r}"] for r in REWARDS]
    + [["pipeline=baseline"], ["logger=wandb"]]
    + [
        ["reward=density", "reward.prop_cfg.0.target=ascending", "reward.prop_cfg.0.maxv=8.0"],
        ["+pipeline.finetune_mode=ddpo", "model.finetune_cfg.lr=3e-6", "eval_size=7",
         "sample_cfg.filter=null", "+model.config_overrides.sample_clip=30.0"],
        ["model=mattergen", "eval_size=5", "sample_cfg.filter.metrics=[validity, novel]",
         "+x.y={a: 1, b: [2, 3]}", "seed=5", "model.sample_cfg.max_atoms=8"],
        ["pipeline=baseline", "model=mattergen_mag_density", "rl_epoch=3",
         "model.sample_cfg.properties_to_condition_on.dft_mag_density=0.2"],
    ]
)


@pytest.mark.parametrize("overrides", GRID, ids=lambda o: " ".join(o) or "defaults")
def test_load_config_equals_jax(overrides):
    ours = config.load_config(CONFIGS, "base", overrides)
    assert ours == jax_config.load_config(str(CONFIGS), "base", overrides)


def test_calc_and_interpolation_resolve_and_unsafe_calc_is_refused():
    cfg = config.load_config(CONFIGS, "base", ["eval_size=5"])
    assert cfg["model"]["sample_cfg"]["batch_size"] == 60
    assert cfg["pipeline"]["sample_cfg"] == cfg["sample_cfg"]
    assert config._safe_calc("2 ** 3 - 1 / 4") == 7.75
    for bad in ("__import__('os').getcwd()", "open('x')", "(1).real", "[1][0]"):
        with pytest.raises(ValueError, match="disallowed"):
            config._safe_calc(bad)
        with pytest.raises(ValueError, match="disallowed"):
            jax_config._safe_calc(bad)


def test_override_values_parse_as_jax_parses_them():
    for raw in ("1e-4", "3", "0.5", "null", "true", "[a, b]", "{k: v}", "x", "'q'", "", "a: b"):
        assert config._parse_override_value(raw) == jax_config._parse_override_value(raw)
    with pytest.raises(ValueError, match="key=value"):
        config.load_config(CONFIGS, "base", ["rl_epoch"])


def test_save_config_round_trips(tmp_path):
    cfg = config.load_config(CONFIGS, "base", ["reward=fom_gap_dielectric", "model=mattergen"])
    cfg["obj"] = object()
    config.save_config(cfg, tmp_path / "h.yaml")
    back = yaml.safe_load((tmp_path / "h.yaml").read_text())
    assert read_yaml(tmp_path / "h.yaml") == back
    assert back.pop("obj").startswith("<object")
    cfg.pop("obj")
    assert back == cfg


def test_targets_map_to_the_port_and_locate_reaches_class_attributes():
    assert config.port_target("matinvent_tpu.pipeline.filters.OptFilter") == \
        "matinvent_tpu_torch.pipeline.filters.OptFilter"
    from matinvent_tpu_torch.pipeline.filters import ReferenceDataset

    assert config.locate("matinvent_tpu_torch.pipeline.filters.ReferenceDataset.from_files") == \
        ReferenceDataset.from_files
    ref = config.instantiate({
        "_target_": "matinvent_tpu.pipeline.filters.ReferenceDataset.from_files",
        "energies_path": str(ROOT / "experiments" / "data" / "reference_energies.json"),
    })
    assert isinstance(ref, ReferenceDataset) and ref.hull is not None
    node = {"_target_": "matinvent_tpu.chem.relax.SoftSphereRelaxer", "steps": 3,
            "_recursive_": False}
    relaxer = config.instantiate(node, "cpu")
    assert relaxer.steps == 3 and relaxer.device.type == "cpu"
    assert config.instantiate({"a": [1, {"b": 2}]}) == {"a": [1, {"b": 2}]}
    raw = config.instantiate({"_target_": "builtins.dict", "_recursive_": False,
                              "x": {"_target_": "nowhere.Thing"}})
    assert raw == {"x": {"_target_": "nowhere.Thing"}}
    hp = config.port_targets(config.load_config(CONFIGS, "base"))
    assert hp["model"]["_target_"].startswith("matinvent_tpu_torch.")
    assert hp["sample_cfg"]["filter"]["_target_"] == "matinvent_tpu_torch.pipeline.filters.OptFilter"


@pytest.mark.parametrize("name", REWARDS)
def test_every_reward_config_instantiates_or_names_what_is_not_ported(name, tmp_path, monkeypatch):
    """Each reward group builds the port's ``Reward`` with its calculators on
    the CPU (device-side ones with ``device`` cpu), ALIGNN and DFT
    included; nothing is left that raises ``NotImplementedError``."""
    from matinvent_tpu_torch.rewards.reward import Reward

    monkeypatch.chdir(tmp_path)
    cfg = config.load_config(CONFIGS, "base", [f"reward={name}"])
    reward = config.instantiate(cfg["reward"], "cpu", "reward")
    if name in LATE_PORTS:
        calc = reward.prop_cfg[0]["calculator"]
        assert f"{type(calc).__module__}.{type(calc).__name__}" == LATE_PORTS[name]
    assert isinstance(reward, Reward)
    assert [p["name"] for p in reward.prop_cfg] == [p["name"] for p in cfg["reward"]["prop_cfg"]]
    for p, node in zip(reward.prop_cfg, cfg["reward"]["prop_cfg"]):
        calc = p["calculator"]
        assert type(calc).__name__ == node["calculator"]["_target_"].rsplit(".", 1)[1]
        assert type(calc).__module__.startswith("matinvent_tpu_torch.")
        if hasattr(calc, "device"):
            assert calc.device.type == "cpu"
    assert os.path.isdir(tmp_path / "rewards")


def test_wandb_logger_raises_jax_s_message_without_wandb():
    from matinvent_tpu_torch.pipeline.logger import WandBLogger

    with pytest.raises(ImportError, match="wandb is not installed"):
        WandBLogger(name="x", project="y")
    cfg = config.load_config(CONFIGS, "base", ["logger=wandb"])
    with pytest.raises(ImportError, match="use logger=csv"):
        config.instantiate(cfg["logger"], "cpu", "logger")


def test_flat_checkpoint_reader_agrees_with_the_general_reader():
    for path in sorted((ROOT / "experiments" / "results").rglob("config.yaml")):
        assert config.read_flat_yaml(path) == read_yaml(path)
