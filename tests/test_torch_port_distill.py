"""The port's score distillation against the JAX package's
``tools/distill_mattergen.py``, on the CPU.

* The demo teacher for a seed equals the JAX tool's bit for bit, and the
  archived ``experiments/results/distilled_mattergen/teacher_last.ckpt``
  loads strictly into both with equal outputs.
* One distillation step on JAX's own noised batch (recorded inside the JAX
  tool's jitted ``distill``), the same student weights and the same
  teacher targets: the loss and its three parts and the gradients' global
  norm within rtol 1e-5, the weights after one AdamW step within 1e-7
  wherever the gradient lies above its f32 noise (below it, Adam's first
  step ``lr g / (|g| + eps)`` turns that noise into up to ``lr``: there
  ``tests/test_torch_port_pretrain.py``'s bound, 2 lr on at most 1%); the
  cosine-decay schedule within ``lr * 2**-23`` at every step of a 50-step
  run (``tests/test_torch_port_pretrain.py``'s schedule tolerance).
* ``heldout_match`` on JAX's noised batches: every field within rtol 1e-5
  (and the 5e-7 of the JAX summary's rounding to 6 decimals).
* A T=8 teacher-scored sample on JAX's draws within 1e-4, running no net.
* End to end at the JAX test's settings: the student beats the untrained
  net by 2x on every field, and the output loads in both suites.
* The GemNet refusal and the teacher loaders as in JAX.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matinvent_tpu.models.diffcsp import sinusoidal_time_embedding as jax_time_embedding
from matinvent_tpu.models.mattergen.diffusion import MatterGenConfig as JaxConfig
from matinvent_tpu.models.mattergen.diffusion import MatterGenDiffusion as JaxDiffusion
from matinvent_tpu.models.suite.mattergen import MatterGenSuite as JaxSuite
from matinvent_tpu.models.suite.mattergen_import import (
    mattergen_state_dict_from_params as jax_state_dict_from_params,
)
from matinvent_tpu_torch.chem.structure import Structure, save_extxyz
from matinvent_tpu_torch.models.mattergen.diffusion import (
    ArrayNoise,
    MatterGenConfig,
    MatterGenDiffusion,
    MGNoised,
)
from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite, params_from_jax
from matinvent_tpu_torch.models.suite.mattergen_import import mattergen_params_from_state_dict
from matinvent_tpu_torch.parallel.pretrain import cosine_decay_lr
from matinvent_tpu_torch.tools import distill_mattergen as port

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARCHIVED_TEACHER = ROOT / "experiments/results/distilled_mattergen/teacher_last.ckpt"
VOCAB = 20
SMALL = dict(hidden_dim=24, num_layers=2, time_dim=24, timesteps=10, max_atomic_num=VOCAB,
             sample_clip=30.0)
MAX_ATOMS = 6
LR = 2e-3


@pytest.fixture(scope="module")
def jtool():
    spec = importlib.util.spec_from_file_location(
        "jax_distill_mattergen", ROOT / "tools" / "distill_mattergen.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX test's corpus: 200 cubic cells of 2-4 atoms from seed 0."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(200):
        n = int(rng.integers(2, 5))
        species = rng.integers(1, 19, n).tolist()
        coords = rng.uniform(0, 1, (n, 3))
        a = float(rng.uniform(3.0, 6.0))
        out.append(Structure.from_parameters([a] * 3, [90] * 3, species, coords))
    path = tmp_path_factory.mktemp("distill") / "corpus.extxyz"
    save_extxyz(out, str(path))
    return str(path)


def _teachers(jtool, vocab=VOCAB, seed=0):
    """(JAX tool's demo teacher, the port's), both on the CPU."""
    return (jtool.TorchTeacher(jtool.DemoTeacherNet.build(type_vocab=vocab, seed=seed), vocab),
            port.TorchTeacher(port.DemoTeacherNet.build(vocab, seed=seed, device="cpu"), vocab))


def _port_model(cfg: dict, params=None) -> MatterGenDiffusion:
    model = MatterGenDiffusion(MatterGenConfig(**cfg), device="cpu")
    if params is not None:
        sd = params_from_jax(jax.tree.map(np.asarray, params))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def _batches(jtool, corpus, n=2, batch=16):
    """The first ``n`` batches of both tools for the same numpy seed."""
    jb = jtool.structure_batches(corpus, batch, MAX_ATOMS, np.random.default_rng(0))[:n]
    pb = port.structure_batches(corpus, batch, MAX_ATOMS, np.random.default_rng(0))[:n]
    for a, b in zip(jb, pb):
        for f in ("atom_types", "frac_coords", "lattice", "num_atoms"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f).numpy())
    return jb, pb


def _to_port(noised) -> MGNoised:
    return MGNoised(*(torch.from_numpy(np.array(x)) for x in noised))


def _record_add_noise(monkeypatch) -> list:
    """Every noised batch the JAX diffusion's ``add_noise`` returns, jitted
    or not (through ``jax.debug.callback``)."""
    seen = []
    real = JaxDiffusion.add_noise

    def add_noise(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        jax.debug.callback(lambda *x: seen.append(tuple(np.array(a) for a in x)), *out[0])
        return out

    monkeypatch.setattr(JaxDiffusion, "add_noise", add_noise)
    return seen


# ------------------------------------------------------------------ teacher


def test_demo_teacher_equals_the_jax_tools_and_keeps_the_global_rng(jtool):
    state = torch.get_rng_state()
    net = port.DemoTeacherNet.build(100, seed=0, device="cpu")
    assert torch.equal(torch.get_rng_state(), state)
    ref = jtool.DemoTeacherNet.build(type_vocab=100, seed=0)
    assert list(net.state_dict()) == list(ref.state_dict())
    for k, v in ref.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k


def _teacher_inputs(B=4, A=MAX_ATOMS, vocab=100, seed=1):
    rng = np.random.default_rng(seed)
    na = rng.integers(1, A + 1, B)
    return (rng.integers(0, vocab, (B, A)), rng.uniform(size=(B, A, 3)).astype(np.float32),
            (np.eye(3)[None] * 4.0 + rng.normal(0, 0.2, (B, 3, 3))).astype(np.float32),
            rng.uniform(0.1, 1.0, B).astype(np.float32), np.arange(A)[None, :] < na[:, None])


def test_archived_teacher_loads_strictly_into_both_with_equal_outputs(jtool):
    ref, _ = jtool.load_teacher(str(ARCHIVED_TEACHER))
    ours, cfg = port.load_teacher(str(ARCHIVED_TEACHER), device="cpu")
    assert cfg["architecture"] == "demo_gemnet" and isinstance(ours, port.TorchTeacher)
    sd = torch.load(ARCHIVED_TEACHER, map_location="cpu", weights_only=False)["state_dict"]
    ours.module.load_state_dict(sd, strict=True)
    x = _teacher_inputs(vocab=int(cfg["type_vocab"]))
    want = ref(*x)
    got = ours(*(torch.from_numpy(np.asarray(a)) for a in x))
    for k in ("cell", "pos", "atomic_numbers"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_own_container_loads_as_the_native_teacher(jtool, tmp_path):
    """A container of this framework's net (exported by JAX's name map)
    loads as a teacher equal to JAX's net within 1e-5."""
    cfg = dict(hidden_dim=16, num_layers=1, time_dim=16, timesteps=10, max_atomic_num=20)
    jd = JaxDiffusion(JaxConfig(**cfg))
    params = jd.init_params(jax.random.PRNGKey(0), max_atoms=4)
    ckpt = tmp_path / "last.ckpt"
    torch.save({"state_dict": {k: torch.as_tensor(v)
                               for k, v in jax_state_dict_from_params(params).items()},
                "config": cfg}, str(ckpt))
    teacher, _ = port.load_teacher(str(ckpt), device="cpu")
    B, A = 2, 4
    rng = np.random.default_rng(1)
    types_t = rng.integers(0, 20, (B, A))
    pos_t = rng.uniform(0, 1, (B, A, 3)).astype(np.float32)
    cell_t = (np.eye(3)[None] * 4.0 + rng.normal(0, 0.1, (B, 3, 3))).astype(np.float32)
    t = np.array([0.5, 0.9], np.float32)
    mask = np.ones((B, A), bool)
    got = teacher(*(torch.from_numpy(np.asarray(a)) for a in (types_t, pos_t, cell_t, t, mask)))
    want = jd.net.apply(params, jax_time_embedding(jnp.asarray(t) * 10, 16), jnp.asarray(types_t),
                        jnp.asarray(pos_t), jnp.asarray(cell_t), jnp.full((B,), A, jnp.int32),
                        jnp.asarray(mask))
    for k in ("cell", "pos", "atomic_numbers"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)


def test_gemnet_refusal_points_at_the_ports_tool_and_the_wheel_error_is_jaxs(jtool, tmp_path):
    template = {"params": {"x": {"kernel": np.zeros((2, 2), np.float32)}}}
    with pytest.raises(ValueError, match="matinvent_tpu_torch.tools.distill_mattergen"):
        mattergen_params_from_state_dict({"gemnet.int_blocks.0.weight": np.zeros((4, 4))}, template)
    for name in ("distill_mattergen", "convert_mattergen_ckpt", "reward_ceiling"):
        assert importlib.util.find_spec(f"matinvent_tpu_torch.tools.{name}") is not None
    # the loader's message when the weights are missing names the port's converter
    from matinvent_tpu_torch.models.suite.mattergen import load_weights

    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="matinvent_tpu_torch.tools.convert_mattergen_ckpt"):
        load_weights(_port_model(SMALL), tmp_path / "empty")
    # a GemNet container goes to the wheel builder, which needs the external package
    ckpt = tmp_path / "gemnet.ckpt"
    torch.save({"state_dict": {"gemnet.int_blocks.0.weight": torch.zeros(4, 4)},
                "config": {"lightning_module": {}}}, str(ckpt))
    with pytest.raises(ImportError) as ref:
        jtool.load_teacher(str(ckpt))
    with pytest.raises(ImportError) as ours:
        port.load_teacher(str(ckpt), device="cpu")
    assert str(ours.value) == str(ref.value)


def test_builder_argument_loads_a_file_and_a_module(tmp_path, monkeypatch):
    (tmp_path / "tb.py").write_text(
        "def make(cfg, sd):\n    return ('built', cfg['k'], sorted(sd))\n")
    ckpt = tmp_path / "c.ckpt"
    torch.save({"state_dict": {"w": torch.zeros(1)}, "config": {"k": 3}}, str(ckpt))
    teacher, cfg = port.load_teacher(str(ckpt), builder=f"{tmp_path / 'tb.py'}:make", device="cpu")
    assert teacher == ("built", 3, ["w"]) and cfg == {"k": 3}
    monkeypatch.syspath_prepend(str(tmp_path))
    teacher, _ = port.load_teacher(str(ckpt), builder="tb:make", device="cpu")
    assert teacher == ("built", 3, ["w"])


# ------------------------------------------------------------- one step


def test_one_distillation_step_matches_jax(jtool, corpus, monkeypatch):
    """The JAX tool's ``distill`` for one step, its noised batch, teacher
    targets, loss and gradients recorded from inside its jitted functions;
    the port's ``distill_step`` on the same batch, weights and targets."""
    jd = JaxDiffusion(JaxConfig(**SMALL))
    params = jax.jit(lambda k: jd.init_params(k, max_atoms=MAX_ATOMS))(jax.random.PRNGKey(1))
    (jb, *_), (pb, *_) = _batches(jtool, corpus, n=1)
    j_teacher, p_teacher = _teachers(jtool)
    noised_seen = _record_add_noise(monkeypatch)
    rec: dict = {}
    real_vag = jax.value_and_grad

    def value_and_grad(fn, **kw):
        inner = real_vag(fn, **kw)

        def run(p):
            out = inner(p)
            jax.debug.callback(lambda o: rec.update(vag=jax.tree.map(np.array, o)), out)
            return out

        return run

    def teacher(*args):
        rec["targets"] = j_teacher(*args)
        return rec["targets"]

    monkeypatch.setattr(jax, "value_and_grad", value_and_grad)
    j_new = jtool.distill(teacher, jd, params, [jb], 1, LR, jax.random.PRNGKey(2))
    jax.effects_barrier()
    (j_loss, j_parts), j_grads = rec["vag"]

    model = _port_model(SMALL, params)
    noised = _to_port(noised_seen[-1])
    targets = port.teacher_targets(p_teacher, noised, pb.mask)
    for k, v in rec["targets"].items():
        np.testing.assert_array_equal(targets[k].numpy(), v, err_msg=k)
    m = port.distill_step(model, port.distill_optimizer(model, LR), 0, LR, 1, noised, pb, targets)
    np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=1e-5)
    for k, v in zip(("cell", "pos", "type"), j_parts):
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5, err_msg=k)
    norm = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                             for g in jax.tree.leaves(j_grads))))
    np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-5)
    # Adam's first step moves a weight by lr g / (|g| + eps): where |g| lies
    # at the gradients' f32 noise (below 1e-6 of their norm; the gradients
    # themselves agree within 1e-5 of it) the step is ill-conditioned, and
    # there the pretraining test's bound applies (2 lr, at most 1% of entries)
    want = params_from_jax(jax.tree.map(np.asarray, j_new))
    grads = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(want)
    loose = total = 0
    for k in want:
        d = np.abs(got[k] - want[k])
        noisy = np.abs(grads[k]) < 1e-6 * norm
        assert d[~noisy].max(initial=0.0) <= 1e-7, (k, float(d[~noisy].max()))
        assert d.max() <= 2 * LR, k
        loose += int((d > 1e-7).sum())
        total += d.size
    assert loose <= 0.01 * total, (loose, total)


def test_cosine_decay_schedule_matches_optax():
    steps = 50
    sched = jax.jit(optax.cosine_decay_schedule(LR, steps, alpha=port.LR_ALPHA))
    for count in range(steps + 3):
        ref = float(sched(jnp.asarray(count, jnp.int32)))
        assert abs(cosine_decay_lr(count, LR, steps, port.LR_ALPHA) - ref) <= LR * 2.0**-23, count


# ------------------------------------------------------------ held-out


def test_heldout_match_matches_jax(jtool, corpus, monkeypatch):
    jd = JaxDiffusion(JaxConfig(**SMALL))
    init = jax.jit(lambda k: jd.init_params(k, max_atoms=MAX_ATOMS))
    p_student, p_base = init(jax.random.PRNGKey(1)), init(jax.random.PRNGKey(5))
    jb, pb = _batches(jtool, corpus, n=2)
    j_teacher, p_teacher = _teachers(jtool)
    noised_seen = _record_add_noise(monkeypatch)
    ref = jtool.heldout_match(j_teacher, jd, p_student, p_base, jb, jax.random.PRNGKey(3))
    assert len(noised_seen) == len(jb)
    means = port.heldout_means(p_teacher, _port_model(SMALL, p_student), _port_model(SMALL, p_base),
                               pb, noised=[_to_port(n) for n in noised_seen])
    for name, key in (("student", "student_mse"), ("baseline", "untrained_baseline_mse"),
                      ("teacher_scale", "teacher_output_power")):
        assert set(means[name]) == set(ref[key])
        for k, v in ref[key].items():
            assert abs(means[name][k] - v) <= 1e-5 * abs(v) + 5e-7, (key, k, means[name][k], v)
    ours = port.heldout_match(p_teacher, _port_model(SMALL, p_student), _port_model(SMALL, p_base),
                              pb, noised=[_to_port(n) for n in noised_seen])
    assert {k: set(v) for k, v in ours.items()} == {k: set(v) for k, v in ref.items()}


# ------------------------------------------------------ teacher sampling


def _jax_draws(key, B, N, A, V):
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


def test_teacher_scored_sample_on_jax_draws_matches_jax(jtool):
    """8 crystals at cap 6, T=8, scored by the demo teacher: the JAX tool's
    ``TeacherScoredDiffusion`` (its ``pure_callback``) against the port's on
    JAX's draws, within 1e-4; the port's score net never runs."""
    cfg = dict(hidden_dim=16, num_layers=1, time_dim=16, timesteps=8, max_atomic_num=100,
               sample_clip=30.0)
    A = 6
    na = np.array([3, 6, 1, 4, 5, 2, 6, 3], np.int32)
    key = jax.random.PRNGKey(4)
    j_teacher, p_teacher = _teachers(jtool, vocab=100)
    jd = JaxDiffusion(JaxConfig(**cfg))
    ref = jtool.TeacherScoredDiffusion(jd, j_teacher).sample(key, jnp.asarray(na), A)
    model = _port_model(cfg)
    calls = []
    model.decoder.register_forward_hook(lambda *a: calls.append(1))
    out = port.TeacherScoredDiffusion(model, p_teacher).sample(
        _jax_draws(key, len(na), cfg["timesteps"], A, 100), torch.from_numpy(na), A)
    assert calls == []
    np.testing.assert_array_equal(out.atom_types.numpy(), np.asarray(ref.atom_types))
    np.testing.assert_array_equal(out.num_atoms.numpy(), na)
    np.testing.assert_allclose(out.lattice.numpy(), np.asarray(ref.lattice), rtol=0, atol=1e-4)
    d = np.abs(out.frac_coords.numpy() - np.asarray(ref.frac_coords))
    np.testing.assert_allclose(np.minimum(d, 1 - d), 0.0, atol=1e-4)
    # the teacher-scored sampler leaves the student's own sampler as it was
    assert type(model) is MatterGenDiffusion


# ------------------------------------------------------------ end to end


def test_distill_end_to_end_beats_baseline_and_loads_in_both_suites(corpus, tmp_path):
    """The JAX test's settings: the held-out student MSE under half the
    untrained net's on every field; the checkpoint loads in both suites."""
    out = tmp_path / "out"
    summary = port.main([
        "teacher=demo", f"corpus={corpus}", f"out={out}", "steps=120", "batch=16", "hidden=24",
        "layers=2", "timesteps=10", "max_atoms=6", "type_vocab=20", "sample_check_n=4",
        "lr=2e-3", "device=cpu",
    ])
    m = summary["heldout_match"]
    for field in ("cell", "pos", "type_kl"):
        assert m["student_mse"][field] < 0.5 * m["untrained_baseline_mse"][field], (field, m)
    assert set(summary) == {"teacher", "steps", "batch", "hidden", "layers", "timesteps",
                            "heldout_match", "sampled_statistics"}
    assert set(summary["sampled_statistics"]) == {"teacher_sampled", "student_sampled",
                                                  "type_hist_l1"}
    assert (out / "teacher_last.ckpt").exists() and (out / "distill_summary.json").exists()
    model = MatterGenSuite(model_path=str(out), device="cpu").load_model()
    assert model.config.hidden_dim == 24
    jd, params = JaxSuite(model_path=str(out)).load_model()
    assert jd.config.hidden_dim == 24
    want = params_from_jax(jax.tree.map(np.asarray, params))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
