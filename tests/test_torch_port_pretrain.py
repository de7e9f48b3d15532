"""The port's pretraining against the JAX package's, on the CPU.

Tiny nets (h32, 2 layers, time_dim 16, T=8) of both families and 3
crystals with odd atom counts. The port is handed JAX's exact draws,
rebuilt here from JAX's keys: DiffCSP's ``add_noise`` splits its key in 4
(integer times, lattice, coords, types); MatterGen's ``training_loss``
splits its key in two (the corruption, the condition dropout), the
corruption's in 4 (uniform times, cell normal, coords normal, type Gumbel,
since ``categorical = argmax(logits + gumbel)``), and folds each sorted
condition field's index into the dropout key.

Tolerances. The loss differs only by f32 summation order: within 1e-5
relative. Each gradient, and each gradient after the clip, lies within
1e-5 of the gradients' global norm. The learning-rate schedule agrees
with optax's f32 evaluation within one f32 ulp of the peak rate (``lr *
2**-23``): the arithmetic is the same, but XLA's f32 cosine differs from
the port's by an ulp at some arguments, which ``1 + cos`` magnifies
relative to the small rates at the end of the decay. After one Adam step from fresh
moments every entry moves by ``lr * g / (|g| + eps)``, about ``lr *
sign(g)``: where a gradient lies at f32 noise level the two packages may
move it in opposite directions, so every weight agrees within ``2 lr``
and all but 1% of the entries within ``lr / 100``.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matinvent_tpu.chem.structure import read_extxyz as jax_read_extxyz
from matinvent_tpu.models.batch import CrystalBatch as JaxBatch
from matinvent_tpu.models.diffcsp import DiffCSPConfig as JaxCSPConfig
from matinvent_tpu.models.diffcsp import DiffCSPDiffusion as JaxCSP
from matinvent_tpu.models.mattergen.diffusion import MatterGenConfig as JaxMGConfig
from matinvent_tpu.models.mattergen.diffusion import MatterGenDiffusion as JaxMG
from matinvent_tpu.parallel import pretrain as jax_pretrain
from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.diffcsp import DiffCSPConfig, DiffCSPDiffusion
from matinvent_tpu_torch.models.diffcsp import NoiseDraws as CSPDraws
from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
    NoiseDraws as MGDraws,
)
from matinvent_tpu_torch.models.suite.mattergen import params_from_jax
from matinvent_tpu_torch.parallel.pretrain import (
    PretrainTrainer,
    structures_to_batches,
    warmup_cosine_lr,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "experiments", "data", "reference.extxyz")
BASE = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8)
NA = np.array([2, 5, 3], np.int32)
A = 5
B = len(NA)
LR = 1e-3
FIELD = "dft_mag_density"


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.arange(A)[None, :] < NA[:, None]
    types = np.where(mask, rng.integers(1, 101, (B, A)), 0).astype(np.int32)
    frac = (rng.uniform(size=(B, A, 3)) * mask[..., None]).astype(np.float32)
    lat = (np.eye(3)[None] * 4.0 + 0.4 * rng.normal(size=(B, 3, 3))).astype(np.float32)
    jb = JaxBatch(jnp.asarray(types), jnp.asarray(frac), jnp.asarray(lat), jnp.asarray(NA))
    tb = CrystalBatch(*(torch.from_numpy(np.array(x)) for x in (types, frac, lat, NA)))
    return jb, tb


def _np(tree) -> dict[str, np.ndarray]:
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _family(name: str, conditional: bool = False):
    """(JAX diffusion, its params, the port's module with those weights)."""
    if name == "diffcsp":
        jd = JaxCSP(JaxCSPConfig(**BASE))
        model = DiffCSPDiffusion(DiffCSPConfig(**BASE), device="cpu")
    else:
        fields = (FIELD,) if conditional else ()
        jd = JaxMG(JaxMGConfig(**BASE, condition_fields=fields))
        model = MatterGenDiffusion(MatterGenConfig(**BASE, condition_fields=fields), device="cpu")
    # jitted: flax's eager init of the DiffCSP net takes seconds op by op
    params = jax.jit(lambda k: jd.init_params(k, batch_size=2, max_atoms=A))(jax.random.PRNGKey(0))
    model.load_state_dict({k: torch.tensor(v) for k, v in _np(params).items()}, strict=True)
    return jd, params, model


def _given(name: str, jd, key, conditions=None, cond_dropout=0.1) -> dict:
    """The port's ``draws``/``t``/``cond_mask`` for JAX's ``training_loss``
    at ``key``."""
    if name == "diffcsp":
        kt, kl, kx, ktype = jax.random.split(key, 4)
        return dict(
            t=torch.from_numpy(np.array(jd.beta.uniform_sample_t(kt, B))),
            draws=CSPDraws(*(torch.from_numpy(np.array(jax.random.normal(k, s))) for k, s in (
                (kl, (B, 3, 3)), (kx, (B, A, 3)), (ktype, (B, A, 100))))),
        )
    k_noise, k_drop = jax.random.split(key)
    kt, kc, kp, ktype = jax.random.split(k_noise, 4)
    T = jd.config.timesteps
    given = dict(
        t=torch.from_numpy(np.array(jax.random.uniform(kt, (B,), minval=1.0 / T, maxval=1.0))),
        draws=MGDraws(
            torch.from_numpy(np.array(jax.random.normal(kc, (B, 3, 3)))),
            torch.from_numpy(np.array(jax.random.normal(kp, (B, A, 3)))),
            torch.from_numpy(np.array(jax.random.gumbel(ktype, (B, A, jd.d3pm.vocab)))),
        ),
    )
    if conditions:
        given["cond_mask"] = {
            f: torch.from_numpy(np.array(
                jax.random.uniform(jax.random.fold_in(k_drop, i), (B,)) >= cond_dropout))
            for i, f in enumerate(sorted(conditions))
        }
    return given


def _global_norm(grads: dict[str, np.ndarray]) -> float:
    return float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads.values())))


def _port_grads(model) -> dict[str, np.ndarray]:
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def _assert_grads(port: dict, ref: dict, norm: float):
    assert set(port) == set(ref)
    for k in ref:
        err = float(np.abs(port[k] - ref[k]).max())
        assert err <= 1e-5 * norm, f"{k}: {err} > 1e-5 x {norm}"


def _assert_adam_step(port: dict, ref: dict, lr: float):
    worst, loose, total = 0.0, 0, 0
    for k in ref:
        d = np.abs(port[k] - ref[k])
        worst = max(worst, float(d.max()))
        loose += int((d > lr / 100).sum())
        total += d.size
    assert worst <= 2 * lr, worst
    assert loose <= 0.01 * total, (loose, total)


CASES = [("diffcsp", False, "adam"), ("mattergen", False, "adamw"), ("mattergen", True, "adam")]


@pytest.mark.parametrize("name,conditional,opt", CASES)
def test_loss_gradients_and_one_step_match_optax(name, conditional, opt):
    """One ``PretrainTrainer.step`` of each family against JAX's
    ``training_loss`` (jitted ``value_and_grad``) and the JAX trainer's
    optax chain: the loss and its parts, the gradients' global norm, the
    clipped gradients (``grad_clip`` small enough to clip) and the weights
    after Adam or AdamW; the conditional case drops some rows' condition
    and keeps others'."""
    jd, params, model = _family(name, conditional)
    jb, tb = _batches(1)
    wd, clip = (0.05 if opt == "adamw" else 0.0), 0.05
    key = jax.random.PRNGKey(3)
    cond = {FIELD: np.array([0.2, -0.1, 0.4], np.float32)} if conditional else None
    kw = {}
    if cond:
        kw = dict(conditions={k: jnp.asarray(v) for k, v in cond.items()}, cond_dropout=0.5)

    (j_loss, j_parts), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jd.training_loss(p, jb, key, **kw), has_aux=True))(params)
    jt = jax_pretrain.PretrainTrainer(jd, lr=LR, grad_clip=clip, weight_decay=wd)
    updates, _ = jt.optimizer.update(j_grads, jt.optimizer.init(params), params)
    j_params = optax.apply_updates(params, updates)
    clipped, _ = optax.clip_by_global_norm(clip).update(j_grads, None)
    norm = _global_norm(_np(j_grads))
    assert norm > clip

    trainer = PretrainTrainer(model, lr=LR, grad_clip=clip, weight_decay=wd, cond_dropout=0.5)
    optimizer = trainer.optimizer()
    assert type(optimizer) is (torch.optim.AdamW if wd else torch.optim.Adam)
    given = _given(name, jd, key, cond, 0.5)
    if cond:
        assert 0 < int(given["cond_mask"][FIELD].sum()) < B
    metrics = trainer.step(
        optimizer, 0, tb, None if cond is None else {k: torch.from_numpy(v) for k, v in cond.items()},
        **given)
    np.testing.assert_allclose(float(metrics["loss"]), float(j_loss), rtol=1e-5)
    for k, v in j_parts.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm, rtol=1e-5)
    _assert_grads(_port_grads(model), _np(clipped), norm)
    port = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    _assert_adam_step(port, _np(j_params), LR)


@pytest.mark.parametrize("lr,total,warmup", [(1e-3, 100, 200), (1.5e-3, 20000, 200),
                                             (3e-4, 57, 3), (1e-3, 30000, 5000)])
def test_schedule_matches_optax_at_every_step(lr, total, warmup):
    """The learning rate of each step tested (every step for the short
    schedules; the warmup, its edges and 500 others for the long ones)
    against optax's schedule as JAX's trainer builds it."""
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, min(warmup, total // 10 + 1), total, lr * 0.02)
    trainer = PretrainTrainer(torch.nn.Linear(1, 1), lr=lr, total_steps=total, warmup_steps=warmup)
    assert trainer.warmup_steps == min(warmup, total // 10 + 1)
    if total <= 1000:
        counts = np.arange(total + 5)
    else:
        w = trainer.warmup_steps
        counts = np.unique(np.concatenate([
            np.arange(0, w + 3), np.linspace(0, total + 5, 500).astype(int), [total - 1, total]]))
    ours = np.array([trainer.learning_rate(int(c)) for c in counts])
    theirs = np.array([float(ref(jnp.asarray(c, jnp.int32))) for c in counts])
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=lr * 2.0**-23)
    assert ours[0] == 0.0
    assert PretrainTrainer(torch.nn.Linear(1, 1), lr=lr).learning_rate(5) == lr


def test_step_follows_the_schedule_and_a_zero_first_rate_leaves_the_weights():
    jd, params, model = _family("diffcsp")
    _, tb = _batches()
    trainer = PretrainTrainer(model, lr=LR, total_steps=40)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = trainer.optimizer()
    g = torch.Generator().manual_seed(0)
    trainer.step(opt, 0, tb, generator=g)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    for count in (1, 3, 4, 5, 39):
        trainer.step(opt, count, tb, generator=g)
        assert opt.param_groups[0]["lr"] == trainer.learning_rate(count)
    assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_ema_update_matches_jax():
    jd, params, model = _family("mattergen")
    noise = jax.jit(lambda k: jd.init_params(k, batch_size=2, max_atoms=A))(jax.random.PRNGKey(5))
    ema_j = jax.tree.map(lambda p, n: p + 0.1 * n, params, noise)
    jt = jax_pretrain.PretrainTrainer(jd, ema_decay=0.9)
    ref = _np(jt.ema_update(ema_j, params))
    trainer = PretrainTrainer(model, ema_decay=0.9)
    ema = {k: torch.tensor(v) for k, v in _np(ema_j).items()}
    trainer.ema_update(ema)
    for k, v in ref.items():
        np.testing.assert_allclose(ema[k].numpy(), v, rtol=0, atol=1e-7)


def test_train_logs_snapshots_and_returns_the_ema():
    """``history`` at step 1 and every ``log_every``-th; ``snapshot_cb`` at
    every ``snapshot_every``-th step and at the end with the weights and the
    EMA; the EMA after each step is ``e d + p (1 - d)``; the returned
    weights are the EMA's; conditional batches train."""
    _, _, model = _family("mattergen", conditional=True)
    _, tb = _batches()
    d = 0.8
    trainer = PretrainTrainer(model, lr=LR, total_steps=7, ema_decay=d)
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    ema_step = trainer.ema_update

    def tracked(e):  # the reference EMA, kept beside the trainer's
        for k, p in model.named_parameters():
            ema[k] = ema[k] * d + p.detach() * (1 - d)
        ema_step(e)

    trainer.ema_update = tracked
    snaps = []
    batches = iter([(tb, {FIELD: torch.tensor([0.1, 0.2, 0.3])})] * 7)
    weights, history = trainer.train(
        batches, 7, torch.Generator().manual_seed(1), log_every=3, snapshot_every=3,
        snapshot_cb=lambda step, w, e: snaps.append((step, w, e)))
    assert len(history) == 3  # steps 1, 3, 6
    assert set(history[0]) == {"loss", "loss_cell", "loss_pos", "loss_types", "grad_norm"}
    assert [s[0] for s in snaps] == [3, 6, 7]
    assert all(s[2] is not None for s in snaps)
    for k, v in ema.items():
        torch.testing.assert_close(weights[k], v, rtol=0, atol=1e-7)
        torch.testing.assert_close(snaps[-1][2][k], weights[k], rtol=0, atol=0)
        torch.testing.assert_close(snaps[-1][1][k], model.state_dict()[k], rtol=0, atol=0)
    assert any(not torch.equal(weights[k], model.state_dict()[k]) for k in ema)


def test_structures_to_batches_are_bit_equal_to_jax():
    """30 batches of 16 (past an epoch's end) from the same numpy seed."""
    port_s, jax_s = read_extxyz(REFERENCE)[:300], jax_read_extxyz(REFERENCE)[:300]
    ours = structures_to_batches(port_s, 16, 4, np.random.default_rng(4))
    theirs = jax_pretrain.structures_to_batches(jax_s, 16, 4, np.random.default_rng(4))
    usable = sum(1 for s in port_s if 1 <= s.num_atoms <= 4)
    assert 30 * 16 > usable  # the draws cross an epoch
    for _ in range(30):
        a, b = next(ours), next(theirs)
        for f in ("atom_types", "frac_coords", "lattice", "num_atoms"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
    with pytest.raises(ValueError, match="no structures fit"):
        next(structures_to_batches(port_s, 4, 0, np.random.default_rng(0)))


def test_pretrain_tool_writes_a_checkpoint_both_suites_load(tmp_path):
    """``tools.pretrain`` on a small corpus: the checkpoint loads into the
    port's and the JAX package's ``DiffCSPSuite`` with equal weights, and
    the port samples from it."""
    from matinvent_tpu.models.suite.diffcsp import DiffCSPSuite as JaxSuite
    from matinvent_tpu_torch.models.suite.diffcsp import DiffCSPSuite
    from matinvent_tpu_torch.tools import pretrain

    data = tmp_path / "corpus.extxyz"
    from matinvent_tpu_torch.chem.structure import save_extxyz

    save_extxyz(read_extxyz(REFERENCE)[:64], str(data))
    out = tmp_path / "ckpt"
    model, history = pretrain.main([
        f"data={data}", f"output_dir={out}", "steps=3", "batch_size=8", "max_atoms=8",
        "model.model_cfg.hidden_dim=32", "model.model_cfg.num_layers=2",
        "model.model_cfg.time_dim=16", "model.model_cfg.timesteps=8", "device=cpu"])
    assert len(history) == 3 and all(np.isfinite(h["loss"]) for h in history)
    cfg = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8)
    suite = DiffCSPSuite(model_path=str(out), model_cfg=cfg, sample_cfg={"max_atoms": 8},
                         config_overrides={"sample_clip": 15.0}, device="cpu")
    loaded = suite.load_model()
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)
    _, j_params = JaxSuite(model_path=str(out), model_cfg=cfg).load_model()
    for k, v in _np(j_params).items():
        np.testing.assert_array_equal(loaded.state_dict()[k].numpy(), v)
    batch = suite.get_sampler().launch(loaded, batch_size=4, num_batches=1)
    assert torch.isfinite(batch.frac_coords).all()
