"""The port's fine-tune half against the JAX package's, on the CPU.

A tiny config (h32, 2 layers, time_dim 16, T=8, accum_steps 4) and 3
crystals with odd atom counts. The port is handed JAX's exact draws, rebuilt
here from JAX's keys: ``FinetuneStep`` folds the chunk index into the epoch
key, ``rl_chunk_loss`` folds in each grid index, and ``add_noise`` splits
that key in 4 (time, cell normal, coords normal, type Gumbel, since
``categorical = argmax(logits + gumbel)``).

Tolerances. The loss and the gradients of one chunk differ only by f32
summation order: the loss within 1e-5 relative, each gradient within 1e-4
of its tensor's largest entry. Over an epoch Adam's first steps move each
parameter by about ``lr * sign(g)``, so an entry whose gradient is at f32
noise level can move the other way in the two packages: after the 2 steps
of an epoch every parameter agrees within ``4 * lr`` (2 steps, each at most
``2 * lr`` apart), and all but 1% of entries agree within ``lr / 100``. The
epoch's metrics average the second chunk's losses too, taken after one such
step, so they agree within 1e-4 relative.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from matinvent_tpu.models.batch import CrystalBatch as JaxBatch
from matinvent_tpu.models.mattergen.corruption import (
    LatticeVPSDE as JaxVPSDE,
    TypeD3PM as JaxD3PM,
    WrappedCoordVE as JaxVE,
)
from matinvent_tpu.models.mattergen.diffusion import (
    MatterGenConfig as JaxConfig,
    MatterGenDiffusion as JaxDiffusion,
)
from matinvent_tpu.parallel.train import FinetuneStep as JaxFinetuneStep
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.mattergen.corruption import (
    LatticeVPSDE,
    TypeD3PM,
    WrappedCoordVE,
)
from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
    NoiseDraws,
)
from matinvent_tpu_torch.models.suite.mattergen import params_from_jax, params_to_jax
from matinvent_tpu_torch.parallel.train import FinetuneStep

torch.set_num_threads(1)

BASE = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8)
ACCUM, LR, SIGMA = 4, 1e-3, 0.1
NA = np.array([2, 5, 3], np.int32)
A = 5


def _batch_np(seed=0):
    rng = np.random.default_rng(seed)
    B = len(NA)
    mask = np.arange(A)[None, :] < NA[:, None]
    types = np.where(mask, rng.integers(1, 101, (B, A)), 0).astype(np.int32)
    frac = (rng.uniform(size=(B, A, 3)) * mask[..., None]).astype(np.float32)
    lat = (np.eye(3)[None] * 4.0 + 0.4 * rng.normal(size=(B, 3, 3))).astype(np.float32)
    return types, frac, lat


def _batches():
    types, frac, lat = _batch_np()
    jb = JaxBatch(jnp.asarray(types), jnp.asarray(frac), jnp.asarray(lat), jnp.asarray(NA))
    tb = CrystalBatch(*(torch.from_numpy(np.array(x)) for x in (types, frac, lat, NA)))
    return jb, tb


def _load(params) -> MatterGenDiffusion:
    model = MatterGenDiffusion(MatterGenConfig(**BASE), device="cpu")
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return model


def _models():
    """JAX diffusion, agent and prior params (the agent perturbed, so the KL
    term is not 0), and the port's agent and prior."""
    jd = JaxDiffusion(JaxConfig(**BASE))
    prior = jd.init_params(jax.random.PRNGKey(0), batch_size=2, max_atoms=A)
    noise = jd.init_params(jax.random.PRNGKey(1), batch_size=2, max_atoms=A)
    agent = jax.tree.map(lambda p, n: p + 0.05 * n, prior, noise)
    return jd, agent, prior, _load(agent), _load(prior)


def _draws(key, t_indices, B, V):
    """The draws of ``rl_chunk_loss(key, t_indices)``: per t, the key
    ``fold_in(key, t)`` split in 4 as ``add_noise`` splits it."""
    cells, poss, gums = [], [], []
    for t in t_indices:
        _, kc, kp, kt = jax.random.split(jax.random.fold_in(key, int(t)), 4)
        cells.append(np.array(jax.random.normal(kc, (B, 3, 3))))
        poss.append(np.array(jax.random.normal(kp, (B, A, 3))))
        gums.append(np.array(jax.random.gumbel(kt, (B, A, V))))
    return NoiseDraws(*(torch.from_numpy(np.stack(x)) for x in (cells, poss, gums)))


def _close_by_scale(port: dict, ref: dict, rel: float):
    assert set(port) == set(ref)
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1e-12)
        err = float(np.abs(port[k] - ref[k]).max())
        assert err <= rel * scale, f"{k}: {err} > {rel} x {scale}"


def test_marginals_and_hybrid_loss_on_jax_draws():
    rng = np.random.default_rng(3)
    B, V = len(NA), 100
    t = rng.uniform(0.05, 1.0, B).astype(np.float32)
    types, frac, lat = _batch_np(1)
    key = jax.random.PRNGKey(11)
    k1, k2, k3 = jax.random.split(key, 3)
    tt = torch.from_numpy(t)

    j_lat, j_eps, j_std = JaxVPSDE().sample_marginal(k1, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(NA))
    eps = torch.from_numpy(np.array(jax.random.normal(k1, lat.shape)))
    p_lat, _, p_std = LatticeVPSDE().sample_marginal(torch.from_numpy(lat), tt, torch.from_numpy(NA), eps)
    np.testing.assert_allclose(eps.numpy(), np.asarray(j_eps), rtol=0, atol=0)
    np.testing.assert_allclose(p_lat.numpy(), np.asarray(j_lat), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p_std.numpy(), np.asarray(j_std), rtol=1e-6)

    j_x, j_eps, j_sig = JaxVE().sample_marginal(k2, jnp.asarray(frac), jnp.asarray(t))
    eps = torch.from_numpy(np.array(jax.random.normal(k2, frac.shape)))
    p_x, _, p_sig = WrappedCoordVE().sample_marginal(torch.from_numpy(frac), tt, eps)
    np.testing.assert_allclose(p_x.numpy(), np.asarray(j_x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        WrappedCoordVE().score_target(eps, p_sig).numpy(),
        np.asarray(JaxVE().score_target(j_eps, j_sig)), rtol=1e-5, atol=1e-5,
    )

    x0 = np.clip(types - 1, 0, 99)
    mask = torch.from_numpy(np.arange(A)[None, :] < NA[:, None])
    for kind in ("uniform", "absorbing"):
        jd3 = JaxD3PM.create(num_classes=100, num_steps=1000, kind=kind)
        pd3 = TypeD3PM.create(num_classes=100, num_steps=1000, kind=kind)
        vocab = pd3.vocab
        gumbel = torch.from_numpy(np.array(jax.random.gumbel(k3, (B, A, vocab))))
        j_xt = np.asarray(jd3.sample_marginal(k3, jnp.asarray(x0), jnp.asarray(t)))
        p_xt = pd3.sample_marginal(torch.from_numpy(x0), tt, gumbel)
        np.testing.assert_array_equal(p_xt.numpy(), j_xt)
        logits = rng.normal(size=(B, A, vocab)).astype(np.float32)
        j_loss = jd3.hybrid_loss(
            jnp.asarray(x0), jnp.asarray(j_xt), jnp.asarray(logits), jnp.asarray(t),
            jnp.asarray(mask.numpy()),
        )
        p_loss = pd3.hybrid_loss(torch.from_numpy(x0), p_xt, torch.from_numpy(logits), tt, mask)
        np.testing.assert_allclose(p_loss.numpy(), np.asarray(j_loss), rtol=1e-5, atol=1e-6)


def test_rl_chunk_loss_and_gradients_match_jax():
    jd, agent_p, prior_p, agent, prior = _models()
    jb, tb = _batches()
    rewards = np.array([0.0, 0.6, 1.0], np.float32)
    key = jax.random.PRNGKey(5)
    t_idx = np.arange(4, 8)

    def loss_fn(p):
        return jd.rl_chunk_loss(p, prior_p, jb, jnp.asarray(rewards), key, jnp.asarray(t_idx), SIGMA)

    (j_loss, (j_diff, j_kl)), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(agent_p)
    draws = _draws(key, t_idx, len(NA), jd.d3pm.vocab)
    loss, (diff, kl) = agent.rl_chunk_loss(
        prior, tb, torch.from_numpy(rewards), torch.from_numpy(t_idx), SIGMA, draws=draws
    )
    loss.backward()
    assert float(kl.detach()) > 0
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(diff), float(j_diff), rtol=1e-5)
    np.testing.assert_allclose(float(kl), float(j_kl), rtol=1e-5)
    ref = params_from_jax(jax.tree.map(np.asarray, j_grads))
    port = {f"decoder.{k}": p.grad.numpy() for k, p in agent.decoder.named_parameters()}
    _close_by_scale(port, ref, 1e-4)
    # the prior is a constant: no gradient reaches it
    assert all(p.grad is None for p in prior.parameters())

    # one timestep alone is the chunk of one
    one, _ = agent.rl_timestep_loss(
        prior, tb, torch.from_numpy(rewards), 6, SIGMA,
        draws=NoiseDraws(*(d[2] for d in draws)),
    )
    j_one, _ = jax.jit(
        lambda p: jd.rl_timestep_loss(
            p, prior_p, jb, jnp.asarray(rewards), jax.random.fold_in(key, 6), 6, SIGMA
        )
    )(agent_p)
    np.testing.assert_allclose(float(one), float(j_one), rtol=1e-5)


def _epoch_draws(ek, B, V):
    return lambda c: _draws(
        jax.random.fold_in(ek, c), c * ACCUM + np.arange(ACCUM), B, V
    )


def test_finetune_epoch_matches_jax_and_nan_guard_keeps_state():
    jd, agent_p, prior_p, agent, prior = _models()
    jb, tb = _batches()
    rewards = np.array([0.2, 0.9, 0.5], np.float32)
    jstep = JaxFinetuneStep(jd, lr=LR, timesteps=8, accum_steps=ACCUM, sigma_kl=SIGMA, epochs=1)
    step = FinetuneStep(lr=LR, timesteps=8, accum_steps=ACCUM, sigma_kl=SIGMA, epochs=1)
    ek = jax.random.PRNGKey(9)
    opt_state = jstep.optimizer.init(agent_p)
    j_p, j_opt, j_m = jstep.epoch(agent_p, opt_state, prior_p, jb, jnp.asarray(rewards), ek)
    opt = step.optimizer(agent)
    prior_before = {k: v.clone() for k, v in prior.state_dict().items()}
    m = step.epoch(
        agent, opt, prior, tb, torch.from_numpy(rewards),
        draws=_epoch_draws(ek, len(NA), jd.d3pm.vocab),
    )
    for k in ("loss", "loss_diff", "loss_kl"):
        np.testing.assert_allclose(m[k], float(j_m[k]), rtol=1e-4)
    ref = params_from_jax(jax.tree.map(np.asarray, j_p))
    port = {k: v.detach().numpy() for k, v in agent.state_dict().items()}
    worst, loose, total = 0.0, 0, 0
    for k in ref:
        d = np.abs(port[k] - ref[k])
        worst = max(worst, float(d.max()))
        loose += int((d > LR / 100).sum())
        total += d.size
    assert worst <= 4 * LR, worst
    assert loose <= 0.01 * total, (loose, total)
    assert all(torch.equal(v, prior_before[k]) for k, v in prior.state_dict().items())
    assert int(j_opt[0].count) == 2
    assert all(s["step"] == 2 for s in opt.state.values())

    # a NaN reward makes every chunk's loss NaN: params and Adam state stay
    bad = rewards.copy()
    bad[1] = np.nan
    j_p2, j_opt2, j_m2 = jstep.epoch(j_p, j_opt, prior_p, jb, jnp.asarray(bad), ek)
    assert np.isnan(float(j_m2["loss"]))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), j_p2, j_p)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), j_opt2, j_opt
    )
    before = {k: v.clone() for k, v in agent.state_dict().items()}
    state_before = {
        i: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
        for i, s in enumerate(opt.state.values())
    }
    m2 = step.epoch(
        agent, opt, prior, tb, torch.from_numpy(bad),
        draws=_epoch_draws(ek, len(NA), jd.d3pm.vocab),
    )
    assert np.isnan(m2["loss"])
    assert all(torch.equal(v, before[k]) for k, v in agent.state_dict().items())
    for i, s in enumerate(opt.state.values()):
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(state_before[i][k])), k


def test_run_draws_from_a_generator_and_moves_the_agent():
    _, agent_p, prior_p, agent, prior = _models()
    _, tb = _batches()
    before = {k: v.clone() for k, v in agent.state_dict().items()}
    step = FinetuneStep(lr=LR, timesteps=8, accum_steps=ACCUM, sigma_kl=SIGMA, epochs=2)
    metrics = step.run(agent, prior, tb, torch.tensor([0.1, 0.5, 0.9]),
                       generator=torch.Generator().manual_seed(0))
    assert len(metrics) == 2
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    assert any(not torch.equal(v, before[k]) for k, v in agent.state_dict().items())
    # the agent's weights go back to JAX's tree unchanged in layout
    back = params_to_jax({k: v.detach().numpy() for k, v in agent.state_dict().items()}, agent)
    assert jax.tree.structure(back) == jax.tree.structure(agent_p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(agent_p)):
        assert a.shape == b.shape and a.dtype == np.float32
    again = params_from_jax(back)
    for k, v in agent.state_dict().items():
        np.testing.assert_array_equal(again[k], v.numpy())
