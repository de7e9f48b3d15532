"""The port's MatterGen sampler against the JAX package's, on the CPU.

A tiny config (h32, 2 layers, T=8) samples 3 crystals in both packages. The
port's noise source is handed the exact draws JAX makes, rebuilt here from
JAX's keys (``fold_in(k_scan, i)`` split in 4: normal draws for the cell, the
coords and the corrector, a Gumbel draw for the types, since
``categorical = argmax(logits + gumbel)``), and both start from JAX's prior.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matinvent_tpu.models.mattergen.diffusion import (
    MatterGenConfig as JaxConfig,
    MatterGenDiffusion as JaxDiffusion,
)
from matinvent_tpu.models.mattergen.sample import MatterGenSampler as JaxSampler
from matinvent_tpu.models.mattergen.sample import bucket_split as jax_bucket_split
from matinvent_tpu.models.sample import ATOM_DIST as JAX_ATOM_DIST
from matinvent_tpu_torch.models.mattergen.diffusion import (
    ArrayNoise,
    MatterGenConfig,
    MatterGenDiffusion,
)
from matinvent_tpu_torch.models.mattergen.sample import MatterGenSampler, bucket_split
from matinvent_tpu_torch.models.sample import ATOM_DIST
from matinvent_tpu_torch.models.suite.mattergen import params_from_jax

torch.set_num_threads(1)

# beta_max 1.0 and a damped cell head: a random net does not cancel the
# cell's noise as a trained one does, and under the default VP schedule the
# cell then grows to ~1e5 within 8 steps, where f32 spacing alone exceeds the
# 1e-4 check; this keeps the cell at O(1)
BASE = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8, beta_max=1.0)


def _models(**extra):
    cfg = dict(BASE, **extra)
    jd = JaxDiffusion(JaxConfig(**cfg))
    params = jd.init_params(jax.random.PRNGKey(0), batch_size=2, max_atoms=6)
    params["params"]["cell_out"]["kernel"] = params["params"]["cell_out"]["kernel"] * 0.01
    model = MatterGenDiffusion(MatterGenConfig(**cfg), device="cpu")
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return jd, params, model


def _jax_draws(key, B, A, N, d3pm, n_corrector):
    """The draws ``MatterGenDiffusion.sample`` makes from ``key``; the
    prior classes are ``d3pm.prior_sample``'s (uniform: the integer draw,
    absorbing: all MASK)."""
    V = d3pm.vocab
    k_cell, k_pos, k_type, k_scan = jax.random.split(key, 4)
    prior = (
        np.array(jax.random.normal(k_cell, (B, 3, 3))),
        np.array(jax.random.uniform(k_pos, (B, A, 3))),
        np.array(d3pm.prior_sample(k_type, (B, A))),
    )
    steps = {"cell": [], "pos": [], "gumbel": [], "corr": []}
    for i in range(N):
        kc, kp, kt, kcorr = jax.random.split(jax.random.fold_in(k_scan, i), 4)
        steps["cell"].append(jax.random.normal(kc, (B, 3, 3)))
        steps["pos"].append(jax.random.normal(kp, (B, A, 3)))
        steps["gumbel"].append(jax.random.gumbel(kt, (B, A, V)))
        steps["corr"].append(
            jnp.stack([
                jax.random.normal(jax.random.fold_in(kcorr, ci), (B, A, 3))
                for ci in range(n_corrector)
            ])
        )
    return ArrayNoise(prior, *(np.stack([np.asarray(a) for a in steps[k]])
                               for k in ("cell", "pos", "gumbel", "corr")))


@pytest.mark.parametrize("extra", [
    dict(type_temperature=1.0, d3pm_kind="uniform"),
    dict(type_temperature=0.5, d3pm_kind="uniform"),
    dict(type_temperature=1.0, d3pm_kind="absorbing"),
], ids=["tau1-uniform", "tau0.5-uniform", "tau1-absorbing"])
def test_sampling_with_jax_draws_matches_jax(extra):
    jd, params, model = _models(**extra)
    B, A = 3, 6
    na = np.array([2, 6, 4], np.int32)
    key = jax.random.PRNGKey(7)
    ref = jd.sample(params, key, jnp.asarray(na), max_atoms=A)[0]
    noise = _jax_draws(key, B, A, BASE["timesteps"], jd.d3pm, 1)
    out = model.sample(noise, torch.from_numpy(na), max_atoms=A, fused_edge=True)
    np.testing.assert_allclose(out.frac_coords.numpy(), np.asarray(ref.frac_coords), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.lattice.numpy(), np.asarray(ref.lattice), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(out.atom_types.numpy(), np.asarray(ref.atom_types))
    np.testing.assert_array_equal(out.num_atoms.numpy(), np.asarray(ref.num_atoms))


def test_sample_bucketed_returns_one_batch_per_bucket():
    _, _, model = _models()
    g = torch.Generator().manual_seed(0)
    caps = [4, 8]
    outs = model.sample_bucketed(
        g, [torch.tensor([1, 3, 4, 4]), torch.tensor([5, 8, 7])], caps
    )
    assert len(outs) == 2
    for o, cap, n in zip(outs, caps, (4, 3)):
        assert o.frac_coords.shape == (n, cap, 3) and o.atom_types.shape == (n, cap)
        assert int(o.num_atoms.max()) <= cap
        assert torch.isfinite(o.lattice).all() and torch.isfinite(o.frac_coords).all()
        assert bool(((o.atom_types > 0) == o.mask).all())  # types on real atoms only
        assert bool(((o.frac_coords >= 0) & (o.frac_coords < 1)).all())


def test_sampler_buckets_match_jax_and_restore_draw_order():
    hist = np.asarray(ATOM_DIST["mp_20"])
    np.testing.assert_array_equal(hist, np.asarray(JAX_ATOM_DIST["mp_20"]))
    for n in (24, 256, 1024):
        na = MatterGenSampler(seed=3)._draw_num_atoms(n)
        np.testing.assert_array_equal(na, JaxSampler(seed=3)._draw_num_atoms(n))
        cuts, caps = bucket_split(na, 4, 20, hist=hist)
        jcuts, jcaps = jax_bucket_split(na, 4, 20, hist=hist)
        assert caps == jcaps
        assert [c.tolist() for c in cuts] == [c.tolist() for c in jcuts]

    _, _, model = _models()
    s = MatterGenSampler(batch_size=12, num_batches=1, size_buckets=3, max_atoms=8, seed=1)
    na = MatterGenSampler(max_atoms=8, seed=1)._draw_num_atoms(12)
    batch = s.launch(model)
    assert batch.frac_coords.shape == (12, 8, 3)
    np.testing.assert_array_equal(batch.num_atoms.numpy(), na)  # draw order
    assert bool(((batch.atom_types > 0) == batch.mask).all())
