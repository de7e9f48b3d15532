"""The port's MatterGen score net against the JAX package's at full width.

The in-repo checkpoint ``rl_hhi_rich5`` (h256, 6 layers, time_dim 128) is
loaded into both packages: JAX through its own loader (``params.msgpack``),
the port from ``state_dict.npz``. One noised batch goes through both at f32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from matinvent_tpu.models.mattergen.diffusion import (
    MatterGenConfig as JaxConfig,
    MatterGenDiffusion as JaxDiffusion,
    MGNoised as JaxNoised,
)
from matinvent_tpu.models.suite.mattergen import MatterGenSuite as JaxSuite
from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
    MGNoised,
)
from matinvent_tpu_torch.models.suite.mattergen import load_model, params_from_jax

torch.set_num_threads(1)

CKPT = "experiments/results/rl_hhi_rich5/models/final"


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


def _run_both(jax_diffusion, params, model, x, fused_edge=False):
    ref = jax.jit(
        lambda p: jax_diffusion.apply_net(
            p,
            JaxNoised(*(jnp.asarray(x[k]) for k in ("t", "time_emb", "types", "frac", "lattice"))),
            jnp.asarray(x["num_atoms"]),
            jnp.asarray(x["mask"]),
        )
    )(params)
    T = torch.from_numpy
    noised = MGNoised(T(x["t"]), T(x["time_emb"]), T(x["types"]), T(x["frac"]), T(x["lattice"]))
    with torch.no_grad():
        out = model.apply_net(noised, T(x["num_atoms"]), T(x["mask"]), fused_edge=fused_edge)
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in out.items()}


def test_full_width_checkpoint_matches_jax():
    suite = JaxSuite(model_path=CKPT)
    jax_diffusion, params = suite.load_model()
    model = load_model(CKPT, device="cpu")
    c = model.config
    assert (c.hidden_dim, c.num_layers, c.time_dim, c.timesteps) == (256, 6, 128, 1000)

    # the JAX tree, renamed by the port's rules, is the checkpoint's npz
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    with np.load(f"{CKPT}/state_dict.npz") as npz:
        assert sorted(sd) == sorted(npz.files)
        for k in npz.files:
            np.testing.assert_array_equal(sd[k], npz[k], err_msg=k)

    x = _noised_inputs(B=2, A=8, time_dim=c.time_dim)
    ref, plain = _run_both(jax_diffusion, params, model, x)
    with torch.no_grad():
        T = torch.from_numpy
        noised = MGNoised(T(x["t"]), T(x["time_emb"]), T(x["types"]), T(x["frac"]), T(x["lattice"]))
        fused = model.apply_net(noised, T(x["num_atoms"]), T(x["mask"]), fused_edge=True)
    for k in ref:
        # the tolerance of the JAX package's own fused-vs-plain check
        np.testing.assert_allclose(plain[k], ref[k], atol=2e-4, rtol=0, err_msg=k)
        np.testing.assert_allclose(fused[k].numpy(), plain[k], atol=2e-4, rtol=0, err_msg=k)


def test_condition_embedding_matches_jax():
    """The conditional path (not exercised by the checkpoint): a net with two
    condition fields, some masked to their null embedding."""
    base = dict(
        hidden_dim=32, num_layers=2, time_dim=16, timesteps=8,
        condition_fields=("band_gap", "density"),
    )
    jd = JaxDiffusion(JaxConfig(**base))
    params = jd.init_params(jax.random.PRNGKey(1), batch_size=2, max_atoms=6)
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    assert "decoder.cond_emb.null_band_gap" in sd
    model = MatterGenDiffusion(MatterGenConfig(**base), device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)

    x = _noised_inputs(B=3, A=6, time_dim=16, seed=2)
    cond = {"band_gap": np.array([0.5, 1.5, 3.0], np.float32)}
    use = {"band_gap": np.array([True, False, True])}
    args = [x[k] for k in ("t", "time_emb", "types", "frac", "lattice")]
    ref = jd.apply_net(
        params, JaxNoised(*map(jnp.asarray, args)), jnp.asarray(x["num_atoms"]),
        jnp.asarray(x["mask"]), {k: jnp.asarray(v) for k, v in cond.items()},
        {k: jnp.asarray(v) for k, v in use.items()},
    )
    with torch.no_grad():
        out = model.apply_net(
            MGNoised(*map(torch.from_numpy, args)), torch.from_numpy(x["num_atoms"]),
            torch.from_numpy(x["mask"]), {k: torch.from_numpy(v) for k, v in cond.items()},
            {k: torch.from_numpy(v) for k, v in use.items()},
        )
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=2e-5, rtol=0, err_msg=k)
