"""CSP mode and knn edges of the port against the JAX package, on the CPU.

CSP: ``_composition_batch`` exactly; a T=8 CSP sample of a tiny MatterGen
(h32, 2 layers) on JAX's draws within 1e-4; the sampler's CSP launch holds
every row's types at its composition; a CSP DDPO record then replay at the
recording weights gives ratio 1 (the sampler keeps ``last_fixed_types``).
knn: ``min_image_distances`` within 1e-6 and ``radius_knn_mask`` exactly on
structures without exact ties (an exact tie ranks by atom index in both
packages, which stable-sort the distances); the knn score nets (MatterGen
and ``CSPNet``, H16/L1) within 2e-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matinvent_tpu.models.cspnet import CSPNet as JaxCSPNet
from matinvent_tpu.models.mattergen.diffusion import (
    MatterGenConfig as JaxConfig,
    MatterGenDiffusion as JaxDiffusion,
    MGNoised as JaxNoised,
)
from matinvent_tpu.models.mattergen.sample import MatterGenSampler as JaxSampler
from matinvent_tpu.ops import neighbors as jneighbors
from matinvent_tpu_torch.models.cspnet import CSPNet
from matinvent_tpu_torch.models.mattergen.diffusion import (
    ArrayNoise,
    MatterGenConfig,
    MatterGenDiffusion,
    MGNoised,
)
from matinvent_tpu_torch.models.mattergen.sample import MatterGenSampler
from matinvent_tpu_torch.models.suite.mattergen import params_from_jax
from matinvent_tpu_torch.ops import neighbors as pneighbors
from matinvent_tpu_torch.parallel.train import MatterGenDDPOStep

torch.set_num_threads(1)

# as tests/test_torch_port_sampling.py: beta_max 1.0 and a damped cell head
# keep a random net's cell at O(1) over 8 steps
BASE = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8, beta_max=1.0)
A = 8
COMPS = [{"Fe": 2, "O": 3}, {"Li": 1, "F": 1}, {"Si": 1, "C": 1, "N": 2}]


def _models(**over):
    cfg = {**BASE, **over}
    jd = JaxDiffusion(JaxConfig(**cfg))
    params = jd.init_params(jax.random.PRNGKey(0), batch_size=2, max_atoms=A)
    params["params"]["cell_out"]["kernel"] = params["params"]["cell_out"]["kernel"] * 0.01
    model = MatterGenDiffusion(MatterGenConfig(**cfg), device="cpu")
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return jd, params, model


def _jax_draws(key, B, N, V):
    """The draws ``MatterGenDiffusion.sample`` makes from ``key``."""
    k_cell, k_pos, k_type, k_scan = jax.random.split(key, 4)
    prior = (np.array(jax.random.normal(k_cell, (B, 3, 3))),
             np.array(jax.random.uniform(k_pos, (B, A, 3))),
             np.array(jax.random.randint(k_type, (B, A), 0, V)))
    steps = {"cell": [], "pos": [], "gumbel": [], "corr": []}
    for i in range(N):
        kc, kp, kt, kcorr = jax.random.split(jax.random.fold_in(k_scan, i), 4)
        steps["cell"].append(np.array(jax.random.normal(kc, (B, 3, 3))))
        steps["pos"].append(np.array(jax.random.normal(kp, (B, A, 3))))
        steps["gumbel"].append(np.array(jax.random.gumbel(kt, (B, A, V))))
        steps["corr"].append(np.array(jax.random.normal(jax.random.fold_in(kcorr, 0), (B, A, 3)))[None])
    return ArrayNoise(prior, *(np.stack(steps[k]) for k in ("cell", "pos", "gumbel", "corr")))


# ------------------------------------------------------------------- CSP


def test_composition_batch_matches_jax():
    ours = MatterGenSampler(max_atoms=A, target_compositions_dict=COMPS)._composition_batch(7)
    ref = JaxSampler(max_atoms=A, target_compositions_dict=COMPS)._composition_batch(7)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    big = [{"Fe": 5, "O": 5}]
    with pytest.raises(ValueError, match="exceeds max_atoms"):
        MatterGenSampler(max_atoms=A, target_compositions_dict=big)._composition_batch(2)
    with pytest.raises(ValueError, match="exceeds max_atoms"):
        JaxSampler(max_atoms=A, target_compositions_dict=big)._composition_batch(2)


def test_csp_sample_on_jax_draws_matches_jax():
    jd, params, model = _models()
    types, na = JaxSampler(max_atoms=A, target_compositions_dict=COMPS)._composition_batch(3)
    key = jax.random.PRNGKey(3)
    ref = jd.sample(params, key, jnp.asarray(na), max_atoms=A, fixed_types=jnp.asarray(types))[0]
    out = model.sample(_jax_draws(key, 3, BASE["timesteps"], jd.d3pm.vocab), torch.from_numpy(na),
                       max_atoms=A, fixed_types=torch.from_numpy(types))
    np.testing.assert_array_equal(out.atom_types.numpy(), np.asarray(ref.atom_types))
    np.testing.assert_array_equal(out.atom_types.numpy(), types)
    np.testing.assert_allclose(out.lattice.numpy(), np.asarray(ref.lattice), rtol=0, atol=1e-4)
    d = np.abs(out.frac_coords.numpy() - np.asarray(ref.frac_coords))
    np.testing.assert_allclose(np.minimum(d, 1 - d), 0.0, atol=1e-4)


def test_csp_launch_holds_compositions_and_ddpo_replays_at_ratio_one():
    _, _, model = _models()
    sampler = MatterGenSampler(batch_size=6, num_batches=1, max_atoms=A, size_buckets=2,
                               target_compositions_dict=COMPS, record_trajectories=True)
    final = sampler.launch(model)
    types, na = sampler._composition_batch(6)
    np.testing.assert_array_equal(final.atom_types.numpy(), types)
    np.testing.assert_array_equal(final.num_atoms.numpy(), na)
    assert torch.equal(sampler.last_fixed_types, torch.from_numpy(types))
    st = MatterGenDDPOStep(chunk=4).replay_stats(
        model, sampler.last_trajectory, sampler.last_num_atoms, final.mask,
        fixed_types=sampler.last_fixed_types)
    assert abs(st["ratio_mean"] - 1.0) <= 1e-6 and abs(st["ratio_max"] - 1.0) <= 1e-6
    assert st["clip_frac"] == 0.0
    # unbucketed without recording too, as the JAX sampler samples CSP
    plain = MatterGenSampler(batch_size=6, num_batches=1, max_atoms=A, size_buckets=2)
    out = plain.launch(model, target_compositions_dict=COMPS)
    np.testing.assert_array_equal(out.atom_types.numpy(), types)


# ------------------------------------------------------------------- knn


def _cells(B=4, seed=0):
    rng = np.random.default_rng(seed)
    na = np.array([A, 5, 3, 6][:B], np.int32)
    mask = np.arange(A)[None, :] < na[:, None]
    frac = rng.uniform(size=(B, A, 3)).astype(np.float32)
    lattice = (np.eye(3)[None] * rng.uniform(3.0, 6.0, (B, 1, 1))
               + rng.normal(size=(B, 3, 3)) * 0.4).astype(np.float32)
    return frac, lattice, na, mask


def test_radius_knn_mask_matches_jax():
    frac, lattice, na, mask = _cells()
    dist = pneighbors.min_image_distances(torch.from_numpy(frac), torch.from_numpy(lattice)).numpy()
    ref = np.asarray(jneighbors.min_image_distances(jnp.asarray(frac), jnp.asarray(lattice)))
    np.testing.assert_allclose(dist, ref, rtol=1e-6, atol=0)
    for cutoff, k in ((6.0, 20), (4.0, 3), (3.0, 1)):
        ours = pneighbors.radius_knn_mask(torch.from_numpy(frac), torch.from_numpy(lattice),
                                          torch.from_numpy(mask), cutoff=cutoff, max_neighbors=k)
        jm = jneighbors.radius_knn_mask(jnp.asarray(frac), jnp.asarray(lattice), jnp.asarray(mask),
                                        cutoff=cutoff, max_neighbors=k)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jm))
    # exact ties (a simple cubic cell's six nearest images at one distance)
    # rank by atom index: of two atoms at one distance from atom 0, the first
    frac = np.array([[[0, 0, 0], [0.5, 0, 0], [0, 0.5, 0], [0.25, 0.25, 0.25]]], np.float32)
    m = pneighbors.radius_knn_mask(torch.from_numpy(frac), torch.eye(3)[None] * 4.0,
                                   torch.ones(1, 4, dtype=torch.bool), max_neighbors=2)
    assert m[0, 0].tolist() == [False, True, False, True]


def test_knn_mattergen_score_net_matches_jax():
    over = dict(hidden_dim=16, num_layers=1, edge_style="knn", cutoff=4.0, max_neighbors=3)
    jd, params, model = _models(**over)
    frac, lattice, na, mask = _cells(B=3, seed=2)
    rng = np.random.default_rng(3)
    x = dict(t=np.full(3, 0.4, np.float32),
             time_emb=rng.normal(size=(3, BASE["time_dim"])).astype(np.float32),
             types=rng.integers(0, 100, (3, A)).astype(np.int32), frac=frac, lattice=lattice)
    fields = ("t", "time_emb", "types", "frac", "lattice")
    ref = jd.apply_net(params, JaxNoised(*(jnp.asarray(x[k]) for k in fields)),
                       jnp.asarray(na), jnp.asarray(mask))
    with torch.no_grad():
        out = model.apply_net(MGNoised(*(torch.from_numpy(x[k]) for k in fields)),
                              torch.from_numpy(na), torch.from_numpy(mask))
        fc = _models(hidden_dim=16, num_layers=1)[2].apply_net(
            MGNoised(*(torch.from_numpy(x[k]) for k in fields)), torch.from_numpy(na),
            torch.from_numpy(mask))
    for k in ref:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0, atol=2e-5, err_msg=k)
    # the knn edges change the outputs
    assert max(float((out[k] - fc[k]).abs().max()) for k in out) > 1e-4
    with pytest.raises(ValueError, match="fc edge style"):
        model.apply_net(MGNoised(*(torch.from_numpy(x[k]) for k in fields)),
                        torch.from_numpy(na), torch.from_numpy(mask), fused_edge=True)


def test_knn_cspnet_matches_jax():
    B, H, LAT = 3, 16, 8
    frac, lattice, na, mask = _cells(B=B, seed=4)
    rng = np.random.default_rng(5)
    feats = rng.dirichlet(np.ones(100), (B, A)).astype(np.float32)
    t_emb = rng.normal(size=(B, LAT)).astype(np.float32)
    args = (t_emb, feats, frac, lattice, na, mask)
    kw = dict(hidden_dim=H, latent_dim=LAT, num_layers=1, edge_style="knn", cutoff=4.0,
              max_neighbors=3)
    jnet = JaxCSPNet(**kw)
    params = jnet.init(jax.random.PRNGKey(6), *(jnp.asarray(a) for a in args))
    ref = jnet.apply(params, *(jnp.asarray(a) for a in args))
    net = CSPNet(**kw)
    sd = params_from_jax(jax.tree.map(np.asarray, params), prefix="")
    net.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ours = net(*(torch.from_numpy(np.asarray(a)) for a in args))
    for name, a, b in zip(("lattice_out", "coord_out", "type_out"), ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0, err_msg=name)


def test_knn_model_samples_on_the_plain_net(monkeypatch):
    """A knn model asked to sample through the kernel samples on the plain
    net (the kernel takes fc edges only): the wrapper is never called."""
    from matinvent_tpu_torch.models import cspnet

    calls = []
    monkeypatch.setattr(cspnet, "fused_edge_chain", lambda *a, **k: calls.append(1))
    _, _, model = _models(hidden_dim=16, num_layers=1, edge_style="knn")
    out = model.sample(torch.Generator().manual_seed(0), torch.tensor([3, 5]), max_atoms=A,
                       fused_edge=True)
    assert torch.isfinite(out.lattice).all() and calls == []
