"""Three places where the port's results differed from the JAX package's.

* bf16 LayerNorm: flax normalises in f32, applies its f32 scale and bias in
  f32 and rounds once; the bf16 score net is held against JAX's bf16 net.
* The sampler's time grid against ``jnp.linspace(1.0, 1.0 / N, N)``.
* The checkpoint config reader against ``yaml.safe_load``, and the
  conditional checkpoint it now loads against JAX's ``apply_net``.
"""
from __future__ import annotations

from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from matinvent_tpu.models.mattergen.diffusion import (
    MatterGenConfig as JaxConfig,
    MatterGenDiffusion as JaxDiffusion,
    MGNoised as JaxNoised,
)
from matinvent_tpu.models.suite.mattergen import MatterGenSuite as JaxSuite
from matinvent_tpu_torch.models.cspnet import layer_norm
from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
    MGNoised,
)
from matinvent_tpu_torch.models.suite.mattergen import load_model
from matinvent_tpu_torch.utils.config import read_flat_yaml

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CKPT = "experiments/results/rl_hhi_rich5/models/final"
COND_CKPT = "experiments/results/pretrained_conditional_v2"
FIELDS = ("t", "time_emb", "types", "frac", "lattice")


def _noised_inputs(B, A, time_dim, seed=0):
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


def _jax_net(diffusion, params, x, net=None, conditions=None):
    out = jax.jit(
        lambda p: diffusion.apply_net(
            p, JaxNoised(*(jnp.asarray(x[k]) for k in FIELDS)),
            jnp.asarray(x["num_atoms"]), jnp.asarray(x["mask"]),
            conditions=conditions, net=net,
        )
    )(params)
    return {k: np.asarray(v, dtype=np.float32) for k, v in out.items()}


def _port_net(model, x, conditions=None, **kw):
    T = torch.from_numpy
    with torch.no_grad():
        out = model.apply_net(
            MGNoised(*(T(x[k]) for k in FIELDS)), T(x["num_atoms"]), T(x["mask"]),
            conditions=conditions, **kw,
        )
    return {k: v.float().numpy() for k, v in out.items()}


def _real(a, mask):
    """The rows of real atoms of a per-atom output; a per-crystal one whole."""
    return a[mask] if a.shape[:2] == mask.shape else a


# ------------------------------------------------------------- LayerNorm


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_layer_norm_bf16_matches_flax(in_dtype):
    """``layer_norm`` at bf16 against ``flax.linen.LayerNorm(dtype=bf16)``
    with the same f32 scale and bias: at most one bf16 step apart (a
    rounding of the same f32 value that lands on the other side). Rounding
    the scale and bias to bf16 before applying them, as the port once did,
    misses by up to 1400 steps."""
    rng = np.random.default_rng(0)
    H = 256
    x = (rng.normal(size=(64, H)) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.normal(size=H)).astype(np.float32)
    bias = (0.2 * rng.normal(size=H)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.dtype(in_dtype))
    ref = fnn.LayerNorm(dtype=jnp.bfloat16, epsilon=1e-6).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, xj
    )
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))

    ln = torch.nn.LayerNorm(H, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, in_dtype))
        out = layer_norm(ln, xt, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(out.float().numpy() - ref) <= step)


@pytest.fixture(scope="module")
def hhi_rich5():
    jd, params = JaxSuite(model_path=CKPT).load_model()
    jd16 = JaxDiffusion(jd.config.replace(sample_dtype="bfloat16"))
    return jd16, params, load_model(CKPT, device="cpu")


@pytest.mark.parametrize("fused_edge", [False, True])
def test_bf16_score_net_matches_jax(hhi_rich5, fused_edge):
    """The full-width ``rl_hhi_rich5`` net (h256, 6 layers) at bf16, the
    port's plain path and its fused-edge path (the kernel's plain version
    on the CPU), against JAX's bf16 ``sample_net_plain`` on the same numpy
    inputs, on the real atoms.

    The tolerance is twice JAX's own bf16-against-f32 spread on these
    inputs, per output: two bf16 evaluations that each stay within that
    spread of the f32 result are at most twice it apart. Measured here
    (B=4, A=12, seed 0): the spread is 0.012 / 0.22 / 0.14 for cell / pos /
    types, and the port's plain path is 0.0067 / 0.070 / 0.12 from JAX's
    bf16 net.
    """
    jd16, params, model = hhi_rich5
    x = _noised_inputs(B=4, A=12, time_dim=model.config.time_dim)
    f32 = _jax_net(jd16, params, x, net=jd16.net)
    bf16 = _jax_net(jd16, params, x, net=jd16.sample_net_plain)
    port = _port_net(model, x, dtype=torch.bfloat16, fused_edge=fused_edge)
    m = x["mask"]
    for k in f32:
        spread = np.abs(_real(bf16[k], m) - _real(f32[k], m)).max()
        assert spread > 0, k  # JAX's net did run at bf16
        gap = np.abs(_real(port[k], m) - _real(bf16[k], m)).max()
        assert np.isfinite(port[k]).all(), k
        assert gap <= 2.0 * spread, (k, gap, spread)


# ------------------------------------------------------------- time grid


@pytest.mark.parametrize("N", [8, 1000])
def test_time_grid_matches_jnp_linspace(N):
    """The grid equals JAX's but for a few points at its end: XLA's scalar
    remainder loop rounds ``1 - i r`` to f32 before it adds ``i c``, so
    those points of JAX's grid carry an absolute error of up to one ulp of
    1.0 (2^-24), tens of ulps of the small values there. 1 of 8 points
    differs at T=8 and 7 of 1000 at T=1000; ``torch.linspace`` missed at 3
    and 416 points."""
    ref = np.asarray(jnp.linspace(1.0, 1.0 / N, N))
    model = MatterGenDiffusion(
        MatterGenConfig(timesteps=N, hidden_dim=32, num_layers=1, time_dim=16), device="cpu"
    )
    grid = model.time_grid().numpy()
    assert grid.dtype == np.float32 and grid.shape == ref.shape
    diff = np.nonzero(grid != ref)[0]
    assert len(diff) <= {8: 1, 1000: 7}[N]
    assert np.all(diff >= N - 8)
    assert np.all(np.abs(grid[diff] - ref[diff]) <= 2.0**-24)


def test_step_tables_at_t1000_match_jax_to_the_pinned_gap():
    """The per-step tables at T=1000 against JAX's. What remains after the
    grid is f32 elementwise math (exp, sin and cos of PyTorch against
    XLA's), which cancellation amplifies in ``eps_coef`` and ``post_std``
    near t = 0; the same gaps remain when the port is handed JAX's grid.
    Pinned worst cases (relative for the two coefficients, absolute for the
    embedding): 1.21e-4, 5.92e-5, 3.05e-5. With ``torch.linspace`` the
    embedding missed by 6.1e-5."""
    kw = dict(timesteps=1000, hidden_dim=32, num_layers=1, time_dim=128)
    jt = {k: np.asarray(v, np.float64) for k, v in JaxDiffusion(JaxConfig(**kw))._step_tables().items()}
    pt = {
        k: v.numpy().astype(np.float64)
        for k, v in MatterGenDiffusion(MatterGenConfig(**kw), device="cpu")._step_tables().items()
    }

    def rel(k):
        return np.max(np.abs(pt[k] - jt[k]) / np.maximum(np.abs(jt[k]), 1e-30))

    assert rel("eps_coef") <= 1.25e-4
    assert rel("post_std") <= 6.0e-5
    assert np.max(np.abs(pt["time_emb"] - jt["time_emb"])) <= 3.1e-5


# ---------------------------------------------------------- config reader


def test_config_reader_matches_yaml_safe_load():
    """Every checkpoint ``config.yaml`` in the repo, the conditional ones
    with their block sequences included, reads as ``yaml.safe_load`` reads
    it. (The DFT reward template is a nested mapping, not a checkpoint
    config; the next test holds that it raises.)"""
    paths = sorted(
        p for d in ("experiments", "exp_res") for p in (ROOT / d).rglob("config.yaml")
    )
    assert len(paths) >= 25
    conditional = 0
    for path in paths:
        with open(path) as f:
            ref = yaml.safe_load(f)
        assert read_flat_yaml(path) == ref, path
        conditional += bool(ref.get("condition_stats"))
    assert conditional >= 3


def test_config_reader_reads_nested_sequences_and_raises_on_mappings(tmp_path):
    value = {
        "a": [[1, [2.5, "x y"]], "z", [[]], None, True],
        "b": [[["deep"]]],
        "c": None,
        "d": [],
        "e": "-not-a-list",
    }
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(value))
    assert read_flat_yaml(p) == value
    for text in ("a:\n  b: 1\n", "a:\n- b: 1\n", "a: |\n  x\n", "a: [1, 2]\n"):
        p.write_text(text)
        with pytest.raises(ValueError):
            read_flat_yaml(p)
    with pytest.raises(ValueError):
        read_flat_yaml(ROOT / "matinvent_tpu/rewards/calculators/dft/config.yaml")


def test_conditional_checkpoint_matches_jax():
    """``pretrained_conditional_v2`` (h128, 4 layers, one ``density``
    condition with its standardisation stats) loads in the port and its
    f32 net matches JAX's on a fixed conditional batch, to the 2e-4 of the
    full-width parity test."""
    model = load_model(COND_CKPT, device="cpu")
    c = model.config
    assert c.condition_fields == ("density",)
    assert c.condition_stats[0][0] == "density" and len(c.condition_stats[0]) == 3
    jd, params = JaxSuite(model_path=COND_CKPT).load_model()
    x = _noised_inputs(B=3, A=10, time_dim=c.time_dim, seed=4)
    density = np.array([1.5, 3.0, 6.5], np.float32)
    ref = _jax_net(jd, params, x, conditions={"density": jnp.asarray(density)})
    out = _port_net(model, x, conditions={"density": torch.from_numpy(density)})
    uncond = _port_net(model, x)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], atol=2e-4, rtol=0, err_msg=k)
    # the condition reaches the outputs
    assert max(np.abs(out[k] - uncond[k]).max() for k in out) > 1e-3


# ------------------------------------------- checkpoint load order (fault A)

MG_T1000 = ROOT / "experiments/results/pretrained_mattergen_t1000"


def _converted_copies(tmp_path):
    """Copies of ``pretrained_mattergen_t1000`` holding only
    ``params.msgpack`` + ``config.yaml`` (the layout of
    ``tools/convert_mattergen_ckpt.py to_native``), only a ``last.ckpt``
    written from its state dict, and only a GemNet-named state dict."""
    import shutil

    dirs = {name: tmp_path / name for name in ("msgpack", "ckpt", "gemnet")}
    for d in dirs.values():
        d.mkdir()
        shutil.copy(MG_T1000 / "config.yaml", d / "config.yaml")
    shutil.copy(MG_T1000 / "params.msgpack", dirs["msgpack"] / "params.msgpack")
    with np.load(MG_T1000 / "state_dict.npz") as npz:
        sd = {k: torch.from_numpy(npz[k]) for k in npz.files}
    torch.save({"state_dict": sd, "config": {}}, dirs["ckpt"] / "last.ckpt")
    gemnet = {"decoder.gemnet.int_blocks.0.weight": torch.zeros(2, 2)}
    torch.save({"state_dict": gemnet}, dirs["gemnet"] / "last.ckpt")
    return dirs


@pytest.mark.parametrize("layout", ["msgpack", "ckpt"])
def test_checkpoint_loads_as_jax_loads_it(tmp_path, layout):
    """A directory without ``state_dict.npz`` loads in the port, through the
    module-level ``load_model`` and the suite, to the weights of the
    original and to JAX's f32 ``apply_net`` on the same directory (within
    1e-6 of each output's scale)."""
    from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite

    path = _converted_copies(tmp_path)[layout]
    assert not (path / "state_dict.npz").exists()
    base = load_model(MG_T1000, device="cpu")
    model = load_model(path, device="cpu")
    suite_model = MatterGenSuite(model_path=str(path), device="cpu").load_model()
    for k, v in base.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
        assert torch.equal(suite_model.state_dict()[k], v), k
    jd, params = JaxSuite(model_path=str(path)).load_model()
    x = _noised_inputs(B=3, A=8, time_dim=model.config.time_dim, seed=1)
    ref = _jax_net(jd, params, x)
    out = _port_net(model, x)
    for k in ref:
        scale = max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(out[k], ref[k], atol=1e-6 * scale, rtol=0, err_msg=k)


def test_gemnet_and_empty_checkpoints_raise_as_in_jax(tmp_path):
    from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite

    path = _converted_copies(tmp_path)["gemnet"]
    with pytest.raises(ValueError, match="GemNet"):
        JaxSuite(model_path=str(path)).load_model()
    with pytest.raises(ValueError, match="GemNet"):
        load_model(path, device="cpu")
    with pytest.raises(ValueError, match="GemNet"):
        MatterGenSuite(model_path=str(path), device="cpu").load_model()
    (path / "last.ckpt").unlink()
    with pytest.raises(FileNotFoundError, match="no params.msgpack or"):
        JaxSuite(model_path=str(path)).load_model()
    with pytest.raises(FileNotFoundError, match="no params.msgpack or"):
        load_model(path, device="cpu")
