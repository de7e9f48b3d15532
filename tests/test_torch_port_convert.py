"""The port's MatterGen checkpoint converter against the JAX package's
``tools/convert_mattergen_ckpt.py``, on the CPU.

The torch container is made by JAX's ``to_torch`` from
``experiments/results/pretrained_mattergen_t1000``. Both directions agree
bit for bit: the ``params.msgpack`` trees (decoded by flax) leaf for leaf,
the ``state_dict`` tensors exactly, the ``config.yaml`` files as
``yaml.safe_load`` reads them. Each package's suite loads the other's
output, and the two f32 nets agree within 1e-6 of each output's scale (the
tolerance of ``tests/test_torch_port_faults.py``'s load-order test).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from matinvent_tpu.models.mattergen.diffusion import MGNoised as JaxNoised
from matinvent_tpu.models.suite.mattergen import MatterGenSuite as JaxSuite
from matinvent_tpu.models.suite.mattergen_import import (
    mattergen_state_dict_from_params as jax_state_dict_from_params,
)
from matinvent_tpu_torch.models.mattergen.diffusion import MGNoised
from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite, load_model
from matinvent_tpu_torch.models.suite.mattergen_import import (
    mattergen_params_from_state_dict,
    mattergen_state_dict_from_params,
)
from matinvent_tpu_torch.tools import convert_mattergen_ckpt as port

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MG_T1000 = ROOT / "experiments/results/pretrained_mattergen_t1000"
FIELDS = ("t", "time_emb", "types", "frac", "lattice")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_mattergen_ckpt", ROOT / "tools" / "convert_mattergen_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    return _jax_tool()


@pytest.fixture(scope="module")
def container(jax_tool, tmp_path_factory):
    """JAX's ``to_torch`` of ``pretrained_mattergen_t1000``: its ``last.ckpt``."""
    out = tmp_path_factory.mktemp("jax_torch")
    jax_tool.to_torch([f"in={MG_T1000}", f"out={out}"])
    return out / "last.ckpt"


def _tree(path: Path) -> dict:
    return serialization.msgpack_restore(path.read_bytes())


def _assert_trees_equal(a, b, path=()):
    assert isinstance(b, dict) == isinstance(a, dict), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], (*path, k))
        return
    assert a.dtype == b.dtype and a.shape == b.shape, path
    np.testing.assert_array_equal(a, b, err_msg=str(path))


def _yaml(path: Path) -> dict:
    return yaml.safe_load(path.read_text())


def test_reverse_map_is_the_jax_map_and_the_inverse_of_the_forward_map():
    """``mattergen_state_dict_from_params`` gives JAX's names, order and
    arrays; mapping back through ``mattergen_params_from_state_dict`` gives
    the tree again, exactly."""
    params = _tree(MG_T1000 / "params.msgpack")
    ours = mattergen_state_dict_from_params(params)
    ref = jax_state_dict_from_params(params)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    _assert_trees_equal(mattergen_params_from_state_dict(ours, params), params)


def test_to_native_matches_jax(jax_tool, container, tmp_path):
    jax_tool.to_native([f"in={container}", f"out={tmp_path / 'jax'}"])
    port.main(["to_native", f"in={container}", f"out={tmp_path / 'port'}", "device=cpu"])
    _assert_trees_equal(_tree(tmp_path / "port/params.msgpack"), _tree(tmp_path / "jax/params.msgpack"))
    assert (tmp_path / "port/params.msgpack").read_bytes() == (tmp_path / "jax/params.msgpack").read_bytes()
    assert _yaml(tmp_path / "port/config.yaml") == _yaml(tmp_path / "jax/config.yaml")
    # and the weights are the original checkpoint's
    _assert_trees_equal(_tree(tmp_path / "port/params.msgpack"), _tree(MG_T1000 / "params.msgpack"))


def test_to_torch_matches_jax(container, tmp_path):
    port.main(["to_torch", f"in={MG_T1000}", f"out={tmp_path}", "device=cpu"])
    ours = torch.load(tmp_path / "last.ckpt", map_location="cpu", weights_only=False)
    ref = torch.load(container, map_location="cpu", weights_only=False)
    assert set(ours) == set(ref) == {"state_dict", "config"}
    assert list(ours["state_dict"]) == list(ref["state_dict"])
    for k, v in ref["state_dict"].items():
        assert ours["state_dict"][k].dtype == v.dtype and torch.equal(ours["state_dict"][k], v), k
    assert ours["config"] == ref["config"]
    assert _yaml(tmp_path / "config.yaml") == _yaml(container.parent / "config.yaml")


def test_native_torch_native_round_trip_is_bit_exact(tmp_path):
    port.main(["to_torch", f"in={MG_T1000}", f"out={tmp_path / 'torch'}", "device=cpu"])
    port.main(["to_native", f"in={tmp_path / 'torch/last.ckpt'}", f"out={tmp_path / 'native'}",
               "device=cpu"])
    assert (tmp_path / "native/params.msgpack").read_bytes() == (MG_T1000 / "params.msgpack").read_bytes()
    original = load_model(MG_T1000, device="cpu").state_dict()
    again = load_model(tmp_path / "native", device="cpu").state_dict()
    assert list(again) == list(original)
    for k, v in original.items():
        assert torch.equal(again[k], v), k


def _inputs(B=3, A=8, time_dim=128, seed=1):
    rng = np.random.default_rng(seed)
    na = rng.integers(1, A + 1, (B,)).astype(np.int32)
    na[0] = A
    return dict(
        t=np.full((B,), 0.5, np.float32),
        time_emb=rng.normal(size=(B, time_dim)).astype(np.float32),
        types=rng.integers(0, 100, (B, A)).astype(np.int32),
        frac=rng.uniform(size=(B, A, 3)).astype(np.float32),
        lattice=(np.eye(3)[None] * 4.0 + rng.normal(size=(B, 3, 3)) * 0.3).astype(np.float32),
        num_atoms=na,
        mask=np.arange(A)[None, :] < na[:, None],
    )


def _nets_agree(jax_dir: Path, port_dir: Path):
    """JAX's suite on ``jax_dir`` and the port's on ``port_dir``: f32 nets
    within 1e-6 of each output's scale."""
    jd, params = JaxSuite(model_path=str(jax_dir)).load_model()
    model = MatterGenSuite(model_path=str(port_dir), device="cpu").load_model()
    x = _inputs(time_dim=model.config.time_dim)
    ref = jax.jit(lambda p: jd.apply_net(
        p, JaxNoised(*(jnp.asarray(x[k]) for k in FIELDS)), jnp.asarray(x["num_atoms"]),
        jnp.asarray(x["mask"])))(params)
    with torch.no_grad():
        out = model.apply_net(MGNoised(*(torch.from_numpy(x[k]) for k in FIELDS)),
                              torch.from_numpy(x["num_atoms"]), torch.from_numpy(x["mask"]))
    for k in ref:
        want = np.asarray(ref[k], np.float32)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(out[k].numpy(), want, atol=1e-6 * scale, rtol=0, err_msg=k)


def test_each_package_loads_the_others_output(jax_tool, container, tmp_path):
    port.main(["to_native", f"in={container}", f"out={tmp_path / 'port_native'}", "device=cpu"])
    jax_tool.to_native([f"in={container}", f"out={tmp_path / 'jax_native'}"])
    _nets_agree(tmp_path / "port_native", tmp_path / "jax_native")
    # a directory holding only the port's last.ckpt (+config.yaml) loads in both
    port.main(["to_torch", f"in={MG_T1000}", f"out={tmp_path / 'port_torch'}", "device=cpu"])
    _nets_agree(tmp_path / "port_torch", tmp_path / "port_torch")


def _save(path: Path, sd: dict, config: dict | None = None) -> Path:
    torch.save({"state_dict": {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                "config": config}, path)
    return path


def test_gemnet_shape_and_missing_name_refusals_match_jax(jax_tool, container, tmp_path):
    gemnet = _save(tmp_path / "gemnet.ckpt", {"decoder.gemnet.int_blocks.0.weight": np.zeros((4, 4))},
                   {"hidden_dim": 128})
    sd = torch.load(container, map_location="cpu", weights_only=False)["state_dict"]
    cfg = torch.load(container, map_location="cpu", weights_only=False)["config"]
    missing = _save(tmp_path / "missing.ckpt", {k: v for k, v in list(sd.items())[1:]}, cfg)
    cases = [(gemnet, [], ValueError, "GemNet"),
             (container, ["hidden_dim=64"], ValueError, "checkpoint shape"),
             (missing, [], KeyError, "missing from checkpoint")]
    for path, extra, exc, text in cases:
        with pytest.raises(exc, match=text):
            jax_tool.to_native([f"in={path}", f"out={tmp_path / 'j'}", *extra])
        with pytest.raises(exc, match=text):
            port.main(["to_native", f"in={path}", f"out={tmp_path / 'p'}", *extra, "device=cpu"])


OVERRIDES = ["256", "1e-4", "1.0e-4", "0.5", "true", "False", "null", "~", "fc", "'quoted'",
             "[a, b]", "[]", "0x10", "010", "-3", ".inf", "1_000", "a b"]


@pytest.mark.parametrize("text", OVERRIDES)
def test_cli_overrides_parse_as_yaml_safe_load(text):
    assert port.override_value(text) == yaml.safe_load(text)


def test_cli_overrides_and_config_file_apply_in_jax_order(jax_tool, container, tmp_path):
    """The embedded config, then ``config=``, then the overrides; keys that
    are not config fields are dropped; ``condition_fields`` becomes a tuple."""
    cfg_file = tmp_path / "over.yaml"
    cfg_file.write_text("sample_clip: 10.0\ntimesteps: 500\nnot_a_field: 3\n")
    args = [f"config={cfg_file}", "timesteps=250", "condition_fields=[]", "d3pm_kind=uniform"]
    jax_tool.to_native([f"in={container}", f"out={tmp_path / 'jax'}", *args])
    port.main(["to_native", f"in={container}", f"out={tmp_path / 'port'}", *args, "device=cpu"])
    ours, ref = _yaml(tmp_path / "port/config.yaml"), _yaml(tmp_path / "jax/config.yaml")
    assert ours == ref
    assert (ours["timesteps"], ours["sample_clip"]) == (250, 10.0) and "not_a_field" not in ours
