"""The port's DiffCSP family against the JAX package's, on the CPU.

Random-weight checks use a tiny config (h32, 2 layers, time_dim 16, T=8)
with JAX's weights scaled by 0.02, as the JAX package's own tests scale them
(an untrained net at T=8 otherwise drives the cosine chain, whose last beta
is 0.9999, to inf); checkpoint checks use ``experiments/results/pretrained``
(h128/L4, T=1000). The port is handed JAX's exact draws, rebuilt here from
JAX's keys: ``add_noise`` splits its key in 4 (time, lattice, coords,
types), ``sample`` splits its key in 4 (coords, lattice, types, scan) and
splits ``fold_in(scan key, t)`` in 4 (corrector, lattice, types, coords).

Tolerances, each stated where it is checked: schedule tables exact, but the
Monte-Carlo coordinate normalizer (5e-5 relative, see
``test_sigma_schedule_matches_jax``); geometry 1e-6 relative; the f32 score
net on the checkpoint 2e-4 (the score net's f32 line of PERF.md §3); losses
1e-5 and gradients 1e-4 relative; sampling 1e-4.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matinvent_tpu.models.batch import CrystalBatch as JaxBatch
from matinvent_tpu.models.diffcsp import (
    DiffCSPConfig as JaxConfig,
    DiffCSPDiffusion as JaxDiffusion,
    NoisedInput as JaxNoised,
)
from matinvent_tpu.models.sample import DiffCSPSampler as JaxSampler
from matinvent_tpu.models.suite import torch_import as jax_torch_import
from matinvent_tpu.models.suite.diffcsp import DiffCSPSuite as JaxSuite
from matinvent_tpu.ops import lattice as jlat
from matinvent_tpu.ops.schedules import BetaSchedule as JaxBeta, SigmaSchedule as JaxSigma
from matinvent_tpu.utils.scaler import StandardScaler as JaxScaler
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.diffcsp import (
    CSPArrayNoise,
    DiffCSPConfig,
    DiffCSPDiffusion,
    NoisedInput,
    NoiseDraws,
)
from matinvent_tpu_torch.models.sample import DiffCSPSampler
from matinvent_tpu_torch.models.suite import torch_import
from matinvent_tpu_torch.models.suite.diffcsp import DiffCSPSuite
from matinvent_tpu_torch.models.suite.mattergen import params_from_jax
from matinvent_tpu_torch.ops import lattice as plat
from matinvent_tpu_torch.ops import schedules
from matinvent_tpu_torch.utils.scaler import StandardScaler

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "experiments", "results", "pretrained")
BASE = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8)
NA = np.array([2, 5, 3], np.int32)
A = 5


def _port(jd_params, **cfg) -> DiffCSPDiffusion:
    model = DiffCSPDiffusion(DiffCSPConfig(**{**BASE, **cfg}), device="cpu")
    sd = params_from_jax(jax.tree.map(np.asarray, jd_params))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return model


def _tiny(scale=0.02, **cfg):
    jd = JaxDiffusion(JaxConfig(**{**BASE, **cfg}))
    params = jd.init_params(jax.random.PRNGKey(0), batch_size=2, max_atoms=A)
    params = jax.tree.map(lambda x: x * scale, params)
    return jd, params, _port(params, **cfg)


def _batch_np(seed=0):
    rng = np.random.default_rng(seed)
    B = len(NA)
    mask = np.arange(A)[None, :] < NA[:, None]
    types = np.where(mask, rng.integers(1, 101, (B, A)), 0).astype(np.int32)
    frac = (rng.uniform(size=(B, A, 3)) * mask[..., None]).astype(np.float32)
    lat = (np.eye(3)[None] * 4.0 + 0.4 * rng.normal(size=(B, 3, 3))).astype(np.float32)
    return types, frac, lat


def _batches(seed=0):
    types, frac, lat = _batch_np(seed)
    jb = JaxBatch(jnp.asarray(types), jnp.asarray(frac), jnp.asarray(lat), jnp.asarray(NA))
    tb = CrystalBatch(*(torch.from_numpy(np.array(x)) for x in (types, frac, lat, NA)))
    return jb, tb


def _add_noise_draws(key, B, K):
    _, kl, kx, kt = jax.random.split(key, 4)
    return NoiseDraws(
        torch.from_numpy(np.array(jax.random.normal(kl, (B, 3, 3)))),
        torch.from_numpy(np.array(jax.random.normal(kx, (B, A, 3)))),
        torch.from_numpy(np.array(jax.random.normal(kt, (B, A, K)))),
    )


def _close_by_scale(port: dict, ref: dict, rel: float):
    assert set(port) == set(ref)
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1e-12)
        err = float(np.abs(port[k] - ref[k]).max())
        assert err <= rel * scale, f"{k}: {err} > {rel} x {scale}"


def _circ(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return np.minimum(d, 1.0 - d)


# ------------------------------------------------------------------ schedules

@pytest.mark.parametrize("mode", ["cosine", "linear", "quadratic", "sigmoid"])
@pytest.mark.parametrize("T", [8, 1000])
def test_beta_schedule_equals_jax(mode, T):
    """Built in numpy as JAX builds them and rounded once: exact."""
    p, j = schedules.BetaSchedule.create(T, mode), JaxBeta.create(T, mode)
    for name in ("betas", "alphas", "alphas_cumprod", "sigmas"):
        np.testing.assert_array_equal(getattr(p, name).numpy(), np.asarray(getattr(j, name)), name)


def test_jax_draws_are_jax_random():
    """Threefry bits exactly; the float32 normal within 4 ulp (XLA's log1p
    inside erfinv rounds differently on some inputs)."""
    for seed in (0, 7, 123456):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            schedules.jax_random_bits(schedules.prng_key(seed), (7, 33)),
            np.asarray(jax.random.bits(key, (7, 33), jnp.uint32)),
        )
        ref = np.asarray(jax.random.normal(key, (64, 50)))
        got = schedules.jax_normal(schedules.prng_key(seed), (64, 50))
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert np.all(np.abs(got - ref) <= 4 * ulp)


@pytest.mark.parametrize("T", [8, 1000])
def test_sigma_schedule_matches_jax(T):
    """``sigmas`` exact. ``sigmas_norm`` is a Monte-Carlo mean over 10,000
    float32 draws: the normals differ by a few ulps and the sum's order
    differs from XLA's, so it agrees within 5e-5 relative where it is above
    1e-8 (measured: 5.0e-6 above 1e-6, 2.9e-5 above 1e-8) and within 1e-9
    absolute below, where sigma nears 1 and the score is 0 up to rounding."""
    p, j = schedules.SigmaSchedule.create(T), JaxSigma.create(T)
    np.testing.assert_array_equal(p.sigmas.numpy(), np.asarray(j.sigmas))
    a, b = p.sigmas_norm.numpy(), np.asarray(j.sigmas_norm)
    big = b > 1e-8
    np.testing.assert_allclose(a[big], b[big], rtol=5e-5, atol=0)
    np.testing.assert_allclose(a[~big], b[~big], rtol=0, atol=1e-9)


def test_uniform_sample_t_covers_one_to_T():
    g = torch.Generator().manual_seed(0)
    t = schedules.BetaSchedule.create(8).uniform_sample_t(g, 4000)
    assert int(t.min()) == 1 and int(t.max()) == 8


# -------------------------------------------------------------------- lattice

def _cells():
    rng = np.random.default_rng(4)
    lengths = rng.uniform(2.0, 9.0, (6, 3)).astype(np.float32)
    angles = rng.uniform(60.0, 120.0, (6, 3)).astype(np.float32)
    # degenerate: an impossible angle triple, a flat cell, a zero length
    lengths = np.concatenate([lengths, [[3, 4, 5], [3, 3, 3], [0, 4, 5]]]).astype(np.float32)
    angles = np.concatenate([angles, [[170, 10, 90], [90, 90, 180], [90, 90, 90]]]).astype(np.float32)
    return lengths, angles


def test_lattice_conversions_match_jax_and_stay_finite():
    """Within 1e-6 relative (of each array's scale) on random and
    degenerate cells; degenerate cells stay finite."""
    lengths, angles = _cells()
    pm = plat.lattice_params_to_matrix(torch.from_numpy(lengths), torch.from_numpy(angles))
    jm = np.asarray(jlat.lattice_params_to_matrix(jnp.asarray(lengths), jnp.asarray(angles)))
    assert np.isfinite(pm.numpy()).all()
    np.testing.assert_allclose(pm.numpy(), jm, rtol=0, atol=1e-6 * np.abs(jm).max())
    good = jm[:6]
    pl, pa = plat.lattice_matrix_to_params(torch.from_numpy(good.copy()))
    jl, ja = jlat.lattice_matrix_to_params(jnp.asarray(good))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-6)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=1e-5)  # arccos near 0/180
    np.testing.assert_allclose(pl.numpy(), lengths[:6], rtol=1e-5)

    rng = np.random.default_rng(5)
    frac = rng.uniform(-0.5, 1.5, (9, 4, 3)).astype(np.float32)
    pc = plat.frac_to_cart(torch.from_numpy(frac), torch.from_numpy(jm))
    jc = np.asarray(jlat.frac_to_cart(jnp.asarray(frac), jnp.asarray(jm)))
    np.testing.assert_allclose(pc.numpy(), jc, rtol=0, atol=1e-6 * np.abs(jc).max())
    pf = plat.cart_to_frac(pc[:6], torch.from_numpy(jm[:6]))
    np.testing.assert_allclose(_circ(pf.numpy(), frac[:6] % 1.0), 0.0, atol=1e-5)
    deg = plat.cart_to_frac(pc[6:], torch.from_numpy(jm[6:]))
    assert np.isfinite(deg.numpy()).all()
    vol = plat.lattice_volume(torch.from_numpy(jm))
    np.testing.assert_allclose(vol.numpy(), np.asarray(jlat.lattice_volume(jnp.asarray(jm))),
                               rtol=1e-5, atol=1e-5)


def test_scaler_round_trip_matches_jax():
    x = np.random.default_rng(6).normal(3.0, 2.0, (50, 4)).astype(np.float32)
    p, j = StandardScaler().fit(x), JaxScaler().fit(x)
    np.testing.assert_allclose(p.means.numpy(), np.asarray(j.means), rtol=1e-6)
    np.testing.assert_allclose(p.stds.numpy(), np.asarray(j.stds), rtol=1e-6)
    back = p.inverse_transform(p.transform(x)).numpy()
    np.testing.assert_allclose(back, x, rtol=1e-5, atol=1e-5)
    q = StandardScaler.from_state_dict(p.copy().state_dict())
    np.testing.assert_array_equal(q.means.numpy(), p.means.numpy())


# ------------------------------------------------------------- the checkpoint

@pytest.fixture(scope="module")
def pretrained():
    jsuite = JaxSuite(model_path=CKPT)
    jd, jparams = jsuite.load_model()
    suite = DiffCSPSuite(model_path=CKPT, device="cpu")
    return jd, jparams, suite, suite.load_model()


def test_suite_loads_the_jax_params(pretrained):
    """The port's suite reads ``params.msgpack`` to the same weights."""
    jd, jparams, suite, model = pretrained
    ref = params_from_jax(jax.tree.map(np.asarray, jparams))
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], k)
    assert model.config == DiffCSPConfig.from_dict(
        {f: getattr(jd.config, f) for f in JaxConfig.__dataclass_fields__}
    )


def test_apply_net_on_the_checkpoint_matches_jax(pretrained):
    """The f32 score net within 2e-4 (PERF.md §3's f32 line)."""
    jd, jparams, _, model = pretrained
    rng = np.random.default_rng(7)
    B, Am, K = 4, 8, 100
    na = np.array([8, 3, 5, 1], np.int32)
    mask = np.arange(Am)[None, :] < na[:, None]
    t = np.array([1, 250, 600, 1000])
    from matinvent_tpu.models.diffcsp import sinusoidal_time_embedding as jemb

    temb = np.asarray(jemb(jnp.asarray(t), jd.config.time_dim))
    probs = rng.normal(size=(B, Am, K)).astype(np.float32)
    frac = rng.uniform(size=(B, Am, 3)).astype(np.float32)
    lat = (np.eye(3)[None] * 5.0 + rng.normal(size=(B, 3, 3))).astype(np.float32)
    ref = jd.apply_net(jparams, JaxNoised(*(jnp.asarray(a) for a in (temb, probs, frac, lat))),
                       jnp.asarray(na), jnp.asarray(mask))
    got = model.apply_net(NoisedInput(*(torch.from_numpy(a) for a in (temb, probs, frac, lat))),
                          torch.from_numpy(na), torch.from_numpy(mask))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        m = mask[..., None] if r.ndim == 3 and r.shape[1] == Am else np.ones(1, bool)
        err = np.abs(g.detach().numpy() - r) * m
        assert err.max() <= 2e-4 * max(1.0, np.abs(r).max()), err.max()


def test_save_model_loads_in_the_jax_suite(pretrained, tmp_path):
    """``save_model``'s directory loads bit-equal in the JAX suite, whose
    own ``params.msgpack`` of the same weights has the same bytes; the
    scalers go to ``scalers.npz`` and come back."""
    from flax import serialization

    jd, jparams, suite, model = pretrained
    suite.lattice_scaler = StandardScaler(np.arange(3.0), np.ones(3))
    try:
        suite.save_model(model, tmp_path / "out")
    finally:
        suite.lattice_scaler = None
    out = tmp_path / "out"
    assert (out / "params.msgpack").read_bytes() == serialization.to_bytes(jax.device_get(jparams))
    jd2, jp2 = JaxSuite(model_path=str(out)).load_model()
    for a, b in zip(jax.tree_util.tree_leaves(jp2), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jd2.config == jd.config
    with np.load(out / "state_dict.npz") as sd, np.load(os.path.join(CKPT, "state_dict.npz")) as ref:
        assert set(sd.files) == set(ref.files)
        for k in ref.files:
            np.testing.assert_array_equal(sd[k], ref[k], k)
    again = DiffCSPSuite(model_path=str(out), device="cpu")
    m2 = again.load_model()
    np.testing.assert_array_equal(again.lattice_scaler.means.numpy(), np.arange(3.0))
    for k, v in model.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v), k


def test_torch_import_round_trip_and_ckpt_load(pretrained, tmp_path):
    """``torch_import`` equals the JAX module's on the checkpoint's state
    dict and round-trips it; a reference ``last.ckpt`` loads to the same
    weights as ``params.msgpack``."""
    _, _, _, model = pretrained
    with np.load(os.path.join(CKPT, "state_dict.npz")) as z:
        sd = {k: z[k] for k in z.files}
    tree = torch_import.cspnet_params_from_state_dict(sd, num_layers=4)
    jtree = jax_torch_import.cspnet_params_from_state_dict(sd, num_layers=4)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    back = torch_import.cspnet_state_dict_from_params(tree)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], k)
    ck = tmp_path / "ref"
    ck.mkdir()
    (ck / "config.yaml").write_bytes(open(os.path.join(CKPT, "config.yaml"), "rb").read())
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, ck / "last.ckpt")
    loaded = torch_import.load_torch_checkpoint(str(ck / "last.ckpt"))
    assert set(loaded) == set(sd)
    m2 = DiffCSPSuite(model_path=str(ck), device="cpu").load_model()
    for k, v in model.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v), k


# ----------------------------------------------------------- losses, gradients

def test_add_noise_and_losses_and_gradients_match_jax():
    """``add_noise`` on JAX's draws, ``sample_losses`` and
    ``rl_chunk_loss`` with their gradients against ``jax.grad``: losses
    within 1e-5 relative, each gradient within 1e-4 of its tensor's largest
    entry."""
    jd, agent_p, _ = _tiny(scale=1.0)
    prior_p = jax.tree.map(
        lambda p, n: p + 0.05 * n, agent_p,
        jd.init_params(jax.random.PRNGKey(1), batch_size=2, max_atoms=A),
    )
    agent, prior = _port(agent_p), _port(prior_p)
    jb, tb = _batches()
    B, K = len(NA), 100
    key = jax.random.PRNGKey(3)
    jn, jt, jtimes = jd.add_noise(key, jb, 2)
    pn, pt, ptimes = agent.add_noise(tb, 2, _add_noise_draws(key, B, K))
    np.testing.assert_array_equal(ptimes.numpy(), np.asarray(jtimes))
    for a, b in zip((*pn, *pt), (*jn, *jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)

    def losses(p):
        loss, _ = jd.sample_losses(p, jn, jt, jb.num_atoms, jb.mask)
        return jnp.sum(loss), loss

    (_, j_loss), j_grads = jax.value_and_grad(losses, has_aux=True)(agent_p)
    loss, _ = agent.sample_losses(pn, pt, tb.num_atoms, tb.mask)
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss), rtol=1e-5)
    _close_by_scale({f"decoder.{k}": p.grad.numpy() for k, p in agent.decoder.named_parameters()},
                    params_from_jax(jax.tree.map(np.asarray, j_grads)), 1e-4)
    agent.zero_grad(set_to_none=True)

    rewards = np.array([0.0, 0.6, 1.0], np.float32)
    t_idx = np.arange(4, 8)
    j_chunk = jax.value_and_grad(
        lambda p: jd.rl_chunk_loss(p, prior_p, jb, jnp.asarray(rewards), key,
                                   jnp.asarray(t_idx), 0.1),
        has_aux=True,
    )
    (jl, (jdiff, jkl)), jg = jax.jit(j_chunk)(agent_p)
    draws = [_add_noise_draws(jax.random.fold_in(key, int(t)), B, K) for t in t_idx]
    draws = NoiseDraws(*(torch.stack(d) for d in zip(*draws)))
    pl, (pdiff, pkl) = agent.rl_chunk_loss(prior, tb, torch.from_numpy(rewards),
                                           torch.from_numpy(t_idx), 0.1, draws=draws)
    pl.backward()
    assert float(pkl.detach()) > 0
    for a, b in ((pl, jl), (pdiff, jdiff), (pkl, jkl)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    _close_by_scale({f"decoder.{k}": p.grad.numpy() for k, p in agent.decoder.named_parameters()},
                    params_from_jax(jax.tree.map(np.asarray, jg)), 1e-4)
    assert all(p.grad is None for p in prior.parameters())
    with pytest.raises(ValueError, match="unconditional"):
        agent.rl_chunk_loss(prior, tb, torch.from_numpy(rewards), torch.from_numpy(t_idx), 0.1,
                            draws=draws, conditions={"x": torch.zeros(3)})


def test_training_loss_matches_jax():
    jd, params, model = _tiny(scale=1.0)
    jb, tb = _batches(1)
    key = jax.random.PRNGKey(9)
    j_loss, j_parts = jd.training_loss(params, jb, key)
    j_times = np.asarray(jd.beta.uniform_sample_t(jax.random.split(key, 4)[0], len(NA)))
    loss, parts = model.training_loss(tb, _add_noise_draws(key, len(NA), 100),
                                      times_index=torch.from_numpy(8 - j_times))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for k in ("loss_lattice", "loss_coord", "loss_type"):
        np.testing.assert_allclose(float(parts[k]), float(j_parts[k]), rtol=1e-5)


# -------------------------------------------------------------------- sampling

def _jax_sample_draws(key, B, A_, K, T):
    """The draws ``DiffCSPDiffusion.sample`` makes from ``key``."""
    k_x, k_l, k_t, k_scan = jax.random.split(key, 4)
    prior = (np.array(jax.random.uniform(k_x, (B, A_, 3))),
             np.array(jax.random.normal(k_l, (B, 3, 3))),
             np.array(jax.random.normal(k_t, (B, A_, K))))
    steps = {"corr": [], "lattice": [], "types": [], "coords": []}
    for t in range(T, 0, -1):
        kc, kl, kt, kx = jax.random.split(jax.random.fold_in(k_scan, t), 4)
        steps["corr"].append(np.array(jax.random.normal(kc, (B, A_, 3))))
        steps["lattice"].append(np.array(jax.random.normal(kl, (B, 3, 3))))
        steps["types"].append(np.array(jax.random.normal(kt, (B, A_, K))))
        steps["coords"].append(np.array(jax.random.normal(kx, (B, A_, 3))))
    return CSPArrayNoise(prior, *(np.stack(steps[k]) for k in ("corr", "lattice", "types", "coords")))


@pytest.mark.parametrize("mode", ["free", "keep_lattice", "keep_coords"])
def test_sampling_on_jax_draws_matches_jax(mode):
    """Final lattice, coords (circularly) and types within 1e-4 at T=8;
    fixed-field modes hold their field."""
    cfg = dict(sample_clip=15.0)
    if mode == "keep_lattice":
        cfg["cost_lattice"] = 0.0
    if mode == "keep_coords":
        cfg["cost_coord"] = 0.0
    jd, params, model = _tiny(**cfg)
    types, frac, lat = _batch_np(2)
    kw_j, kw_p = {}, {}
    if mode == "keep_lattice":
        kw_j["fixed_lattice"], kw_p["fixed_lattice"] = jnp.asarray(lat), torch.from_numpy(lat)
    if mode == "keep_coords":
        kw_j["fixed_coords"], kw_p["fixed_coords"] = jnp.asarray(frac), torch.from_numpy(frac)
    key = jax.random.PRNGKey(5)
    ref, _ = jd.sample(params, key, jnp.asarray(NA), max_atoms=A, step_lr=1e-5, **kw_j)
    noise = _jax_sample_draws(key, len(NA), A, 100, BASE["timesteps"])
    out, traj = model.sample(noise, torch.from_numpy(NA), max_atoms=A, step_lr=1e-5, **kw_p)
    assert traj is None
    np.testing.assert_allclose(out.lattice.numpy(), np.asarray(ref.lattice), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_circ(out.frac_coords.numpy(), ref.frac_coords), 0.0, atol=1e-4)
    np.testing.assert_array_equal(out.atom_types.numpy(), np.asarray(ref.atom_types))
    np.testing.assert_array_equal(out.num_atoms.numpy(), np.asarray(ref.num_atoms))
    if mode == "keep_lattice":
        np.testing.assert_array_equal(out.lattice.numpy(), lat)
    if mode == "keep_coords":
        np.testing.assert_allclose(out.frac_coords.numpy(), frac % 1.0, atol=1e-6)


def test_fixed_field_misconfiguration_raises():
    _, _, free = _tiny()
    with pytest.raises(ValueError, match="keep_lattice is off"):
        free.sample(torch.Generator().manual_seed(0), torch.from_numpy(NA), A,
                    fixed_lattice=torch.eye(3).repeat(3, 1, 1))
    _, _, keep = _tiny(cost_coord=0.0)
    with pytest.raises(ValueError, match="no fixed_coords"):
        keep.sample(torch.Generator().manual_seed(0), torch.from_numpy(NA), A)


def test_sampler_draws_as_jax_and_samples_all_batches():
    """The num-atoms draws equal JAX's; ``generate`` returns every crystal
    of the call (batch_size x num_batches), as JAX's does."""
    for seed in (0, 3):
        p = DiffCSPSampler(seed=seed, max_atoms=8)
        j = JaxSampler(seed=seed, max_atoms=8)
        from matinvent_tpu.models.sample import sample_num_atoms as jsna
        from matinvent_tpu_torch.models.sample import sample_num_atoms

        np.testing.assert_array_equal(sample_num_atoms(p._rng, 40), jsna(j._rng, 40))
    _, _, model = _tiny(sample_clip=15.0)
    s = DiffCSPSampler(batch_size=3, num_batches=2, max_atoms=A, step_lr=1e-5)
    data, strucs = s.generate(model)
    assert len(data) == len(strucs) == 6
    assert s.resolved_step_lr() == 1e-5 and DiffCSPSampler().resolved_step_lr() == 5e-6


def test_checkpoint_chain_at_T1000_on_jax_draws(pretrained):
    """The DDPO recipe's sampling (``sample_clip`` 30, at most 8 atoms) on
    the checkpoint at T=1000, recorded, on JAX's draws: 8 crystals. The
    chain amplifies the nets' f32 differences (the saturated cosine step
    multiplies the lattice mean by 100 at t=T), so the lattices drift apart
    over 1,000 steps; what the recipe depends on agrees: the share of
    recorded lattice entries held at the clip, in each stretch of the chain,
    within 0.01; the final types of at least 95% of the real atoms (63 of
    64 measured: the drift can flip a type near the end); and the
    coordinate log-probs of every stochastic step within 1e-3."""
    over = {"sample_clip": 30.0}
    jd, jp = JaxSuite(model_path=CKPT, config_overrides=over).load_model()
    model = DiffCSPSuite(model_path=CKPT, config_overrides=over, device="cpu").load_model()
    na = np.array([2, 8, 5, 6, 3, 8, 4, 7], np.int32)
    key = jax.random.PRNGKey(3)
    ref, jtraj = jd.sample(jp, key, jnp.asarray(na), max_atoms=8, step_lr=5e-6, record_traj=True)
    noise = _jax_sample_draws(key, len(na), 8, 100, 1000)
    out, traj = model.sample(noise, torch.from_numpy(na), 8, step_lr=5e-6, record_traj=True)
    ts = np.asarray(jtraj["timestep"])
    jl, pl = np.asarray(jtraj["next_lattices"]), traj["next_lattices"].numpy()
    for lo, hi in ((1000, 991), (990, 951), (950, 801), (800, 1)):
        sel = (ts <= lo) & (ts >= hi)
        assert abs((np.abs(jl[sel]) >= 30).mean() - (np.abs(pl[sel]) >= 30).mean()) <= 0.01
    real = np.arange(8)[None, :] < na[:, None]
    assert (out.atom_types.numpy() == np.asarray(ref.atom_types))[real].mean() >= 0.95
    np.testing.assert_allclose(traj["log_prob_x"].numpy()[:-1], np.asarray(jtraj["log_prob_x"])[:-1],
                               rtol=0, atol=1e-3)


# ------------------------------------- the verify_smoke DiffCSP checkpoint

VERIFY = os.path.join(ROOT, "exp_res", "verify_smoke", "models", "final")


@pytest.mark.parametrize("T", [None, 8])
def test_verify_smoke_checkpoint_matches_jax(T):
    """``exp_res/verify_smoke/models/final`` (DiffCSP h128/L4, ``time_dim``
    256, cosine, T=1000) loads to JAX's weights; its f32 ``apply_net``
    within 2e-4 of each output's scale and, at T=8, a sample on JAX's draws
    within 1e-4 (coords circularly), types equal."""
    # sample_clip 30 as the DDPO recipes sample: at T=8 an unclipped cell
    # of this checkpoint overflows in both packages
    over = None if T is None else {"timesteps": T, "sample_clip": 30.0}
    jd, jparams = JaxSuite(model_path=VERIFY, config_overrides=over).load_model()
    model = DiffCSPSuite(model_path=VERIFY, config_overrides=over, device="cpu").load_model()
    assert (model.config.hidden_dim, model.config.num_layers, model.config.time_dim) == (128, 4, 256)
    assert model.config.scheduler_mode == "cosine"
    ref_sd = params_from_jax(jax.tree.map(np.asarray, jparams))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref_sd[k], k)
    if T is None:
        rng = np.random.default_rng(8)
        B, Am, K = 4, 8, 100
        na = np.array([8, 2, 5, 1], np.int32)
        mask = np.arange(Am)[None, :] < na[:, None]
        from matinvent_tpu.models.diffcsp import sinusoidal_time_embedding as jemb

        temb = np.asarray(jemb(jnp.asarray(np.array([1, 300, 700, 1000])), jd.config.time_dim))
        probs = rng.normal(size=(B, Am, K)).astype(np.float32)
        frac = rng.uniform(size=(B, Am, 3)).astype(np.float32)
        lat = (np.eye(3)[None] * 5.0 + rng.normal(size=(B, 3, 3))).astype(np.float32)
        ref = jd.apply_net(jparams, JaxNoised(*(jnp.asarray(a) for a in (temb, probs, frac, lat))),
                           jnp.asarray(na), jnp.asarray(mask))
        got = model.apply_net(NoisedInput(*(torch.from_numpy(a) for a in (temb, probs, frac, lat))),
                              torch.from_numpy(na), torch.from_numpy(mask))
        for g, r in zip(got, ref):
            r = np.asarray(r)
            m = mask[..., None] if r.ndim == 3 and r.shape[1] == Am else np.ones(1, bool)
            err = np.abs(g.detach().numpy() - r) * m
            assert err.max() <= 2e-4 * max(1.0, np.abs(r).max()), err.max()
        return
    key = jax.random.PRNGKey(9)
    ref, _ = jd.sample(jparams, key, jnp.asarray(NA), max_atoms=A, step_lr=1e-5)
    noise = _jax_sample_draws(key, len(NA), A, 100, T)
    out, _ = model.sample(noise, torch.from_numpy(NA), max_atoms=A, step_lr=1e-5)
    np.testing.assert_allclose(out.lattice.numpy(), np.asarray(ref.lattice), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_circ(out.frac_coords.numpy(), ref.frac_coords), 0.0, atol=1e-4)
    np.testing.assert_array_equal(out.atom_types.numpy(), np.asarray(ref.atom_types))
