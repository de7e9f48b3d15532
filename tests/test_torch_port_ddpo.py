"""The port's DDPO fine-tune of both families against the JAX package's, on
the CPU, and the entry point's new modes.

Tiny configs at T=8: DiffCSP h32/L2 with JAX's weights scaled by 0.02 (as
the JAX package's own tests scale them) and a sample clip; MatterGen h32/L2
with ``beta_max`` 1 and a damped cell head (as ``test_torch_port_sampling``
sets it). The conditional replay runs the in-repo
``pretrained_conditional_v2`` checkpoint at T=8.

Tolerances, each stated where it is checked: log-probs replayed from a
JAX-recorded trajectory within 1e-4 (ROADMAP Queue 1 item 5); the port's own
record-then-replay gives ratios of 1 within 1e-6 and nothing clipped; one
DDPO update from the same parameters, trajectory and rewards: the loss and
the ratio statistics within 1e-5, the parameters within 1e-6; the DiffCSP
recipe's first update at T=1000, where f32 rounding alone moves JAX's own
loss by orders of magnitude: the ratio statistics within 0.05, the loss no
further from JAX's than JAX's own run from rounding-perturbed weights.
"""
from __future__ import annotations

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matinvent_tpu.models.diffcsp import DiffCSPConfig as JaxCSPConfig
from matinvent_tpu.models.diffcsp import DiffCSPDiffusion as JaxCSP
from matinvent_tpu.models.mattergen.diffusion import (
    MatterGenConfig as JaxMGConfig,
    MatterGenDiffusion as JaxMG,
)
from matinvent_tpu.models.suite.diffcsp import DiffCSPSuite as JaxCSPSuite
from matinvent_tpu.models.suite.mattergen import MatterGenSuite as JaxMGSuite
from matinvent_tpu.parallel.train import (
    DDPOFinetuneStep as JaxDDPO,
    MatterGenDDPOStep as JaxMGDDPO,
)
from matinvent_tpu_torch.models.diffcsp import DiffCSPConfig, DiffCSPDiffusion
from matinvent_tpu_torch.models.mattergen.diffusion import (
    ArrayNoise,
    MatterGenConfig,
    MatterGenDiffusion,
)
from matinvent_tpu_torch.models.mattergen.sample import MatterGenSampler
from matinvent_tpu_torch.models.suite.diffcsp import DiffCSPSuite
from matinvent_tpu_torch.models.suite.mattergen import load_model, params_from_jax
from matinvent_tpu_torch.parallel.train import DDPOFinetuneStep, MatterGenDDPOStep
from matinvent_tpu_torch.pipeline import mat_invent

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COND = os.path.join(ROOT, "experiments", "results", "pretrained_conditional_v2")
CSP = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8, sample_clip=15.0)
MG = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8, beta_max=1.0)
NA = np.array([4, 6, 3], np.int32)
A = 6
STEP_LR = 1e-5
CSP_STATE = ("frac_coords", "lattices", "atom_types", "frac_coords_mid",
             "next_frac_coords", "next_lattices", "next_atom_types")
MG_STATE = ("cell_in", "pos_in", "types_in", "pos_mid", "cell", "pos", "types")


def _load(model, params):
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return model


def _csp(**over):
    cfg = {**CSP, **over}
    jd = JaxCSP(JaxCSPConfig(**cfg))
    params = jax.tree.map(lambda x: x * 0.02,
                          jd.init_params(jax.random.PRNGKey(0), batch_size=2, max_atoms=A))
    return jd, params, _load(DiffCSPDiffusion(DiffCSPConfig(**cfg), device="cpu"), params)


def _mg():
    jd = JaxMG(JaxMGConfig(**MG))
    params = jd.init_params(jax.random.PRNGKey(0), batch_size=2, max_atoms=A)
    params["params"]["cell_out"]["kernel"] = params["params"]["cell_out"]["kernel"] * 0.01
    return jd, params, _load(MatterGenDiffusion(MatterGenConfig(**MG), device="cpu"), params)


def _t(traj):
    return {k: torch.from_numpy(np.array(v)) for k, v in traj.items()}


def _mask(na, a=A):
    return np.arange(a)[None, :] < na[:, None]


@pytest.fixture(scope="module")
def csp_traj():
    jd, params, model = _csp()
    _, traj = jd.sample(params, jax.random.PRNGKey(9), jnp.asarray(NA), max_atoms=A,
                        step_lr=STEP_LR, record_traj=True)
    return jd, params, model, traj


@pytest.fixture(scope="module")
def mg_traj():
    jd, params, model = _mg()
    _, traj = jd.sample(params, jax.random.PRNGKey(1), jnp.asarray(NA), max_atoms=A,
                        record_traj=True)
    return jd, params, model, traj


# ------------------------------------------------------ replay of JAX records

def test_diffcsp_forward_logprob_reproduces_jax_records(csp_traj):
    """Each stochastic transition (t > 1) of a JAX-recorded trajectory:
    ``log_prob_{lattice,types,coords}`` within 1e-4."""
    jd, params, model, traj = csp_traj
    mask = torch.from_numpy(_mask(NA))
    tt = _t(traj)
    for i in range(CSP["timesteps"] - 1):
        state = {k: tt[k][i] for k in CSP_STATE}
        state["timesteps"] = tt["timestep"][i].expand(len(NA))
        state["num_atoms"] = torch.from_numpy(NA)
        with torch.no_grad():
            lp_l, lp_t, lp_x, _ = model.forward_logprob(state, mask, STEP_LR)
        for got, key in ((lp_l, "log_prob_l"), (lp_t, "log_prob_t"), (lp_x, "log_prob_x")):
            np.testing.assert_allclose(got.numpy(), np.asarray(traj[key][i]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{key} step {i}")


def test_mattergen_forward_logprob_reproduces_jax_records(mg_traj):
    """Every grid step of a JAX-recorded trajectory (the last one gated to
    0 in both): ``log_prob_{cell,types,pos}`` within 1e-4."""
    jd, params, model, traj = mg_traj
    mask = torch.from_numpy(_mask(NA))
    tt = _t(traj)
    tables = model._step_tables()
    for i in range(MG["timesteps"]):
        state = {k: tt[k][i] for k in MG_STATE}
        state["step"] = i
        with torch.no_grad():
            lp_c, lp_ty, lp_p, _ = model.forward_logprob(state, torch.from_numpy(NA), mask, tables)
        for got, key in ((lp_c, "log_prob_cell"), (lp_ty, "log_prob_types"), (lp_p, "log_prob_pos")):
            np.testing.assert_allclose(got.numpy(), np.asarray(traj[key][i]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{key} step {i}")


# ----------------------------------------------- the port's own record/replay

def test_diffcsp_record_then_replay_ratio_is_one():
    """At the recording parameters every ratio is 1 within 1e-6: the mean
    too, and none is clipped."""
    _, _, model = _csp()
    final, traj = model.sample(torch.Generator().manual_seed(3), torch.from_numpy(NA), A,
                               step_lr=STEP_LR, record_traj=True)
    assert traj["atom_types"].shape == (8, 3, A, 100) and traj["timestep"].tolist() == list(range(8, 0, -1))
    st = DDPOFinetuneStep(chunk=4, step_lr=STEP_LR).replay_stats(
        model, traj, final.num_atoms, final.mask, rows=torch.tensor([2, 0]))
    assert abs(st["ratio_mean"] - 1.0) <= 1e-6 and abs(st["ratio_max"] - 1.0) <= 1e-6
    assert st["clip_frac"] == 0.0


def test_mattergen_record_then_replay_ratio_is_one():
    _, _, model = _mg()
    final, traj = model.sample(torch.Generator().manual_seed(3), torch.from_numpy(NA), A,
                               record_traj=True)
    for k in ("log_prob_cell", "log_prob_types", "log_prob_pos"):
        assert float(traj[k][-1].abs().max()) == 0.0  # the deterministic last step
    st = MatterGenDDPOStep(chunk=4).replay_stats(model, traj, final.num_atoms, final.mask)
    assert abs(st["ratio_mean"] - 1.0) <= 1e-6 and abs(st["ratio_max"] - 1.0) <= 1e-6
    assert st["clip_frac"] == 0.0
    with pytest.raises(NotImplementedError, match="n_corrector"):
        MatterGenDiffusion(MatterGenConfig(**{**MG, "n_corrector": 2}), device="cpu").sample(
            torch.Generator(), torch.from_numpy(NA), A, record_traj=True)


def _jax_mg_draws(key, B, A_, N, V):
    """The draws ``MatterGenDiffusion.sample`` makes from ``key``."""
    k_cell, k_pos, k_type, k_scan = jax.random.split(key, 4)
    prior = (np.array(jax.random.normal(k_cell, (B, 3, 3))),
             np.array(jax.random.uniform(k_pos, (B, A_, 3))),
             np.array(jax.random.randint(k_type, (B, A_), 0, V)))
    steps = {"cell": [], "pos": [], "gumbel": [], "corr": []}
    for i in range(N):
        kc, kp, kt, kcorr = jax.random.split(jax.random.fold_in(k_scan, i), 4)
        steps["cell"].append(np.array(jax.random.normal(kc, (B, 3, 3))))
        steps["pos"].append(np.array(jax.random.normal(kp, (B, A_, 3))))
        steps["gumbel"].append(np.array(jax.random.gumbel(kt, (B, A_, V))))
        steps["corr"].append(np.array(jax.random.normal(jax.random.fold_in(kcorr, 0), (B, A_, 3)))[None])
    return ArrayNoise(prior, *(np.stack(steps[k]) for k in ("cell", "pos", "gumbel", "corr")))


def test_guided_sampling_on_jax_draws_matches_jax():
    """A tiny conditional model (random weights, as ``_mg``) sampled with
    conditions of +-10 and guidance 2 on JAX's draws: lattice and coords
    within 1e-4, types equal."""
    cfg = {**MG, "condition_fields": ("dft_mag_density",)}
    jd = JaxMG(JaxMGConfig(**cfg))
    params = jd.init_params(jax.random.PRNGKey(0), batch_size=2, max_atoms=A)
    params["params"]["cell_out"]["kernel"] = params["params"]["cell_out"]["kernel"] * 0.01
    model = _load(MatterGenDiffusion(MatterGenConfig(**cfg), device="cpu"), params)
    na = np.array([6, 4], np.int32)
    cond_np = np.array([10.0, -10.0], np.float32)
    key = jax.random.PRNGKey(1)
    ref, _ = jd.sample(params, key, jnp.asarray(na), max_atoms=A,
                       conditions={"dft_mag_density": jnp.asarray(cond_np)}, guidance=2.0)
    out = model.sample(_jax_mg_draws(key, 2, A, 8, jd.d3pm.vocab), torch.from_numpy(na), A,
                       conditions={"dft_mag_density": torch.from_numpy(cond_np)}, guidance=2.0)
    np.testing.assert_allclose(out.lattice.numpy(), np.asarray(ref.lattice), rtol=0, atol=1e-4)
    d = np.abs(out.frac_coords.numpy() - np.asarray(ref.frac_coords))
    np.testing.assert_allclose(np.minimum(d, 1 - d), 0.0, atol=1e-4)
    np.testing.assert_array_equal(out.atom_types.numpy(), np.asarray(ref.atom_types))


@pytest.fixture(scope="module")
def cond_ckpt():
    over = {"timesteps": 8}
    jd, params = JaxMGSuite(model_path=COND, config_overrides=over).load_model()
    return jd, params, load_model(COND, device="cpu", config_overrides=over)


def test_guided_preds_on_the_conditional_checkpoint_match_jax(cond_ckpt):
    """``pretrained_conditional_v2`` at T=8, guidance 2: at every step of a
    JAX-recorded guided trajectory the port's ``_guided_preds`` equal JAX's
    within 2e-4 of each field's scale (the f32 score net's line; guidance
    multiplies the conditional predictions by 3), and the replayed
    log-probs equal the recorded ones within 1e-4."""
    from matinvent_tpu.models.mattergen.diffusion import MGNoised as JaxNoised
    from matinvent_tpu_torch.models.mattergen.diffusion import MGNoised

    jd, params, model = cond_ckpt
    na = np.array([6, 4], np.int32)
    mask = _mask(na)
    cond_np = np.array([10.0, -10.0], np.float32)
    jcond, pcond = {"density": jnp.asarray(cond_np)}, {"density": torch.from_numpy(cond_np)}
    _, traj = jd.sample(params, jax.random.PRNGKey(1), jnp.asarray(na), max_atoms=A,
                        conditions=jcond, guidance=2.0, record_traj=True)
    jt, tt = jd._step_tables(), model._step_tables()
    tr = _t(traj)
    for i in range(8):
        t_j = jnp.full((2,), jt["t"][i])
        emb_j = jnp.broadcast_to(jt["time_emb"][i][None], (2, jd.config.time_dim))
        ref = jd._guided_preds(params, JaxNoised(t_j, emb_j, traj["types_in"][i], traj["pos_in"][i],
                                                 traj["cell_in"][i]),
                               jnp.asarray(na), jnp.asarray(mask), jcond, 2.0, plain=True)
        noised = MGNoised(tt["t"][i].expand(2), tt["time_emb"][i][None].expand(2, -1),
                          tr["types_in"][i], tr["pos_in"][i], tr["cell_in"][i])
        with torch.no_grad():
            got = model._guided_preds(noised, torch.from_numpy(na), torch.from_numpy(mask), pcond,
                                      2.0, fused_edge=False, dtype=torch.float32)
        for k in ("cell", "pos", "atomic_numbers"):
            r = np.asarray(ref[k])
            err = np.abs(got[k].numpy() - r)
            if r.ndim == 3 and r.shape[1] == A:
                err = err * mask[..., None]
            assert err.max() <= 2e-4 * max(1.0, np.abs(r).max()), (i, k, err.max())
        state = {k: tr[k][i] for k in MG_STATE}
        state["step"] = i
        with torch.no_grad():
            lp_c, lp_ty, lp_p, _ = model.forward_logprob(
                state, torch.from_numpy(na), torch.from_numpy(mask), tt, conditions=pcond, guidance=2.0)
        for got_lp, key in ((lp_c, "log_prob_cell"), (lp_ty, "log_prob_types"), (lp_p, "log_prob_pos")):
            np.testing.assert_allclose(got_lp.numpy(), np.asarray(traj[key][i]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{key} step {i}")


def test_conditional_record_then_replay_ratio_is_one(cond_ckpt):
    """The sampler records the behaviour policy's conditions and guidance;
    replayed under them the ratios are 1 within 1e-6, and a replay without
    them is not. 64 crystals: every product then has at least 64 rows in
    the recorder and in the replay, where the CPU's BLAS takes one path
    (with 2 crystals its small-matrix path sums the per-crystal products in
    another order, and the mean ratio moves by 1.8e-6)."""
    _, _, model = cond_ckpt
    s = MatterGenSampler(batch_size=64, num_batches=1, max_atoms=A, record_trajectories=True,
                         diffusion_guidance_factor=2.0, properties_to_condition_on={"density": 10.0},
                         size_buckets=4)
    final = s.launch(model)
    assert s.last_guidance == 2.0 and s.last_fixed_types is None
    np.testing.assert_array_equal(s.last_conditions["density"].numpy(), np.full(64, 10.0))
    step = MatterGenDDPOStep(chunk=4)
    st = step.replay_stats(model, s.last_trajectory, s.last_num_atoms, final.mask,
                           conditions=s.last_conditions, guidance=s.last_guidance)
    assert abs(st["ratio_mean"] - 1.0) <= 1e-6 and st["clip_frac"] == 0.0
    wrong = step.replay_stats(model, s.last_trajectory, s.last_num_atoms, final.mask)
    assert abs(wrong["ratio_max"] - 1.0) > 1e-3


# ------------------------------------------------------- one update vs JAX

def _port_params(model, prefix="decoder."):
    return {k: p.detach().numpy().copy() for k, p in model.named_parameters()}


def _check_update(jstep, jparams, jtraj, jadv, step, model, traj, na, rows, **replay):
    mask = _mask(na)
    opt_state = jstep.optimizer.init(jparams)
    jp, _, jloss, jstats = jstep.update(jparams, opt_state, jtraj, jnp.asarray(na[rows]),
                                        jnp.asarray(mask[rows]), jadv, **replay.get("jax", {}))
    before = _port_params(model)
    adv = torch.from_numpy(np.array(jadv))
    loss, stats = step.update(model, step.optimizer(model), traj, torch.from_numpy(na),
                              torch.from_numpy(mask), adv, rows=torch.from_numpy(rows),
                              **replay.get("port", {}))
    np.testing.assert_allclose(loss, float(jloss), rtol=0, atol=1e-5)
    for k in ("ratio_mean", "ratio_max", "clip_frac"):
        np.testing.assert_allclose(stats[k], float(jstats[k]), rtol=0, atol=1e-5, err_msg=k)
    ref = params_from_jax(jax.tree.map(np.asarray, jp))
    got = _port_params(model)
    moved = max(float(np.abs(got[k] - before[k]).max()) for k in got)
    assert moved > 1e-5  # the update moved the weights well past the tolerance
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6, err_msg=k)


def test_one_diffcsp_ddpo_update_matches_jax():
    """On the linear schedule: at T=8 the cosine one saturates (beta_T =
    0.9999, which the JAX package warns of below 200 steps) and its first
    transition multiplies the nets' f32 differences by 1/sqrt(1e-4), which
    moves the loss by 6e-5."""
    jd, params, model = _csp(scheduler_mode="linear")
    _, traj = jd.sample(params, jax.random.PRNGKey(9), jnp.asarray(NA), max_atoms=A,
                        step_lr=STEP_LR, record_traj=True)
    rows = np.array([2, 0])
    rewards = np.array([0.9, 0.1], np.float32)
    jstep = JaxDDPO(jd, lr=1e-4, chunk=4, step_lr=STEP_LR)
    jtraj = jax.tree.map(lambda x: x[:, rows] if x.ndim >= 2 else x, traj)
    adv = rewards - rewards.mean()
    adv = adv - adv.mean()
    jadv = jnp.asarray(adv / (adv.std() + 1e-6))
    step = DDPOFinetuneStep(lr=1e-4, chunk=4, step_lr=STEP_LR)
    np.testing.assert_allclose(step.advantages(torch.from_numpy(rewards)).numpy(), np.asarray(jadv),
                               rtol=1e-6)
    _check_update(jstep, params, jtraj, jadv, step, model, _t(traj), NA, rows)


def test_first_diffcsp_ddpo_update_in_the_recipes_regime():
    """``rl_hhi_ddpo``'s first update (the checkpoint, the cosine schedule
    at T=1000, ``sample_clip`` 30, chunk 25, lr 3e-6, one epoch) on a
    JAX-recorded trajectory of 4 crystals, through JAX's update, through
    JAX's again from its weights scaled by 1 + 1e-7 noise (f32 rounding's
    size), and through the port's. JAX computes the ratio explosion that
    the port's climbs log: a mean above 1e6 and over a fifth clipped. The
    update is chaotic there: the recorded lattices sit at the clip, where a
    small weight change moves a log-prob by tens, so JAX's own loss moves by
    more than a factor 10 under the perturbation, and no fixed tolerance
    holds a loss. Tolerances: the largest ratio at the log-ratio clip e^20
    in both (1e-6 relative); ``log(ratio_mean)`` and ``clip_frac`` within
    0.05 of JAX's; the port's log-loss no further from JAX's than the
    perturbed JAX run's."""
    over = {"sample_clip": 30.0}
    ckpt = os.path.join(ROOT, "experiments", "results", "pretrained")
    jd, jp = JaxCSPSuite(model_path=ckpt, config_overrides=over).load_model()
    model = DiffCSPSuite(model_path=ckpt, config_overrides=over, device="cpu").load_model()
    na = np.array([2, 8, 5, 6], np.int32)
    mask = _mask(na, 8)
    _, traj = jd.sample(jp, jax.random.PRNGKey(3), jnp.asarray(na), max_atoms=8,
                        step_lr=5e-6, record_traj=True)
    step = DDPOFinetuneStep(lr=3e-6, chunk=25, step_lr=5e-6)
    adv = step.advantages(torch.from_numpy(np.linspace(0.9, 0.1, len(na)).astype(np.float32)))
    jstep = JaxDDPO(jd, lr=3e-6, chunk=25, step_lr=5e-6)

    def jax_update(params):
        _, _, loss, st = jstep.update(params, jstep.optimizer.init(params), traj, jnp.asarray(na),
                                      jnp.asarray(mask), jnp.asarray(adv.numpy()))
        return float(loss), {k: float(v) for k, v in st.items()}

    leaves, tdef = jax.tree.flatten(jp)
    rng = np.random.default_rng(0)
    perturbed = jax.tree.unflatten(
        tdef, [x * (1 + 1e-7 * rng.standard_normal(x.shape)).astype(np.float32) for x in leaves])
    jloss, jst = jax_update(jp)
    ploss, pst = jax_update(perturbed)
    loss, st = step.update(model, step.optimizer(model), _t(traj), torch.from_numpy(na),
                           torch.from_numpy(mask), adv)
    print(f"loss {jloss} / {ploss} / {loss}; ratio_mean {jst['ratio_mean']} / "
          f"{pst['ratio_mean']} / {st['ratio_mean']}; clip_frac {jst['clip_frac']} / "
          f"{pst['clip_frac']} / {st['clip_frac']} (JAX / JAX perturbed / port)")
    assert jst["ratio_mean"] > 1e6 and jst["clip_frac"] > 0.2
    for s in (jst, pst, st):
        np.testing.assert_allclose(s["ratio_max"], np.exp(np.float32(20.0)), rtol=1e-6)
    assert abs(np.log(st["ratio_mean"]) - np.log(jst["ratio_mean"])) <= 0.05
    assert abs(st["clip_frac"] - jst["clip_frac"]) <= 0.05
    assert jloss > 0 and ploss > 0 and loss > 0
    spread = abs(np.log(ploss) - np.log(jloss))
    assert spread > np.log(10.0)
    assert abs(np.log(loss) - np.log(jloss)) <= spread


def test_one_mattergen_ddpo_update_matches_jax(mg_traj):
    jd, params, model, traj = mg_traj
    rows = np.array([0, 1, 2])
    rewards = np.array([0.9, 0.1, 0.5], np.float32)
    jstep = JaxMGDDPO(jd, lr=1e-4, chunk=4)
    step = MatterGenDDPOStep(lr=1e-4, chunk=4)
    jadv = jnp.asarray(step.advantages(torch.from_numpy(rewards)).numpy())
    _check_update(jstep, params, traj, jadv, step, model, _t(traj), NA, rows)


def test_ddpo_clips_the_global_norm_as_optax():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    params = [torch.zeros(2, requires_grad=True), torch.zeros(1, requires_grad=True)]
    for p, gi in zip(params, g):
        p.grad = gi.clone()
    from matinvent_tpu_torch.parallel.train_predictor import clip_by_global_norm_

    clip_by_global_norm_(params, 1.0)
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(x) for x in g], None)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6)


# ------------------------------------------------------------ the entry point

TINY = [
    "--set", "model.model_path=null", "--set", "model.model_cfg.hidden_dim=16",
    "--set", "model.model_cfg.num_layers=1", "--set", "model.model_cfg.time_dim=8",
    "--set", "model.model_cfg.timesteps=10", "--set", "model.model_cfg.sample_clip=15.0",
    "--set", "model.finetune_cfg.timesteps=10", "--set", "pipeline.finetune_cfg.accum_steps=5",
    "--set", "pipeline.finetune_cfg.epochs=1", "--set", "model.sample_cfg.batch_size=6",
    "--set", "model.sample_cfg.max_atoms=6", "--set", "model.config_overrides=null",
    # an untrained model gives almost no valid samples: the filter is off,
    # as the JAX package's own end-to-end test runs it
    "--set", "pipeline.sample_cfg.invalid_filter=false",
    "--set", "pipeline.sample_cfg.filter=null",
]


@pytest.mark.parametrize("recipe", ["diffcsp_hhi", "rl_hhi_ddpo", "rl_hhi_ddpo_mattergen_t1000"])
def test_entry_point_runs_one_tiny_iteration_in_each_new_mode(tmp_path, recipe):
    """One iteration on the CPU: the reward-weighted DiffCSP run, and DDPO
    of both families, whose metrics carry the ``ddpo_*`` columns, and whose
    agent moved. (The tiny untrained nets move far in one update: their
    ratios are not near 1.)"""
    out = tmp_path / "run"
    pipe = mat_invent.main(["--recipe", recipe, "--rl-epoch", "1", "--out", str(out),
                            "--device", "cpu", *TINY])
    with open(out / "metrics.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 1
    ddpo = recipe != "diffcsp_hhi"
    assert (pipe.ddpo is not None) == ddpo
    expected = type(pipe.agent).__name__
    assert expected == ("DiffCSPDiffusion" if "mattergen" not in recipe else "MatterGenDiffusion")
    if ddpo:
        row = rows[0]
        for k in ("ddpo_ratio_mean", "ddpo_ratio_max", "ddpo_clip_frac"):
            assert k in row and row[k] != "", k
        assert np.isfinite(float(row["ddpo_ratio_mean"])) and 0.0 <= float(row["ddpo_clip_frac"]) <= 1.0
        assert len(pipe.ddpo.epoch_stats) == pipe.ddpo.epochs
        assert pipe.sampler.record_trajectories and pipe.sampler.last_trajectory is not None
    assert any(not torch.equal(v, pipe.prior.state_dict()[k])
               for k, v in pipe.agent.state_dict().items())
    assert (out / "models" / "final" / "params.msgpack").exists()


def test_refusals_left(tmp_path):
    """CSP mode is ported and DDPO records its fixed types; DDPO cannot
    overlap sampling with scoring."""
    base = [a for a in TINY if a != "--set"]
    cfg = mat_invent.resolve("rl_hhi_ddpo_mattergen_t1000", 1,
                             base + ['model.sample_cfg.target_compositions_dict=[{"Fe": 2}]'])
    pipe = mat_invent.build(cfg, str(tmp_path / "csp"), device="cpu")
    assert pipe.sampler.target_compositions_dict == [{"Fe": 2}]
    pipe.run_rl()
    assert (pipe.sampler.last_fixed_types[:, :2] == 26).all()
    assert (pipe.sampler.last_fixed_types[:, 2:] == 0).all()
    for recipe in ("rl_hhi_ddpo", "rl_hhi_ddpo_mattergen_t1000"):
        cfg = mat_invent.resolve(recipe, 1, base + ["pipeline.async_sampling=true"])
        with pytest.raises(ValueError, match="async_sampling"):
            mat_invent.build(cfg, str(tmp_path / recipe), device="cpu")


def test_recipes_are_the_archived_jax_runs():
    """The DDPO recipes hold the archived runs' hparams (paths into the
    repository), and the DiffCSP default run resolves its checkpoint."""
    import yaml

    for name in ("rl_hhi_ddpo", "rl_hhi_ddpo_mattergen_t1000"):
        ref = yaml.safe_load(open(os.path.join(ROOT, "experiments/results", name, "hparams.yaml")))
        cfg = mat_invent.RECIPES[name]
        for sec in ("pipeline", "model"):
            for k, v in ref[sec].items():
                if k in ("_target_", "model_path"):
                    continue
                assert cfg[sec][k] == v, (name, sec, k)
        assert cfg["reward"]["prop_cfg"][0]["minv"] == ref["reward"]["prop_cfg"][0]["minv"]
        assert os.path.isdir(mat_invent.resolve(name)["model"]["model_path"])
    assert os.path.isdir(mat_invent.resolve("diffcsp_hhi")["model"]["model_path"])


def _holds_yaml(name: str) -> dict:
    import yaml

    ref = yaml.safe_load(open(os.path.join(ROOT, "experiments/results", name, "hparams.yaml")))
    cfg = mat_invent.RECIPES[name]
    for key in ("seed", "rl_epoch", "sample_cfg", "eval_size"):
        assert cfg[key] == ref[key], (name, key)
    for sec in ("pipeline", "model"):
        for k, v in ref[sec].items():
            if k in ("_target_", "model_path"):
                continue
            assert cfg[sec][k] == v, (name, sec, k)
    r, rr = cfg["reward"], ref["reward"]
    assert r["reward_threshold"] == rr["reward_threshold"] and r["root_dir"] == rr["root_dir"]
    for p, rp in zip(r["prop_cfg"], rr["prop_cfg"], strict=True):
        calc = dict(rp["calculator"])
        cls = calc.pop("_target_").rsplit(".", 1)[-1]
        assert p["calculator"].get("class", "Empirical") == cls
        assert {k: v for k, v in p["calculator"].items() if k != "class"} == calc
        assert {k: p[k] for k in ("name", "target", "minv", "maxv")} == {
            k: rp[k] for k in ("name", "target", "minv", "maxv")}
    resolved = mat_invent.resolve(name)
    assert os.path.isdir(resolved["model"]["model_path"])
    assert os.path.basename(resolved["model"]["model_path"]) == os.path.basename(
        ref["model"]["model_path"])
    return cfg


def test_rl_cond_ddpo_recipe_is_the_archived_jax_run():
    cfg = _holds_yaml("rl_cond_ddpo")
    assert cfg["pipeline"]["finetune_mode"] == "ddpo"
    assert cfg["model"]["sample_cfg"]["properties_to_condition_on"] == {"density": 4.18}
