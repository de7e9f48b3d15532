"""The port's checkpoint export, run state, resume, asynchronous sampling
and profiler, against the JAX package and against an uninterrupted run, on
the CPU.

* ``params.msgpack``: the port's encoder writes flax's bytes exactly; the
  tree it writes restores (``flax.serialization.msgpack_restore``) leaf by
  leaf bitwise equal to the JAX suite's, at full width on the archived
  ``rl_hhi_rich5`` checkpoint and on a conditional model; the JAX suite
  loads the port's directory and its f32 ``apply_net`` agrees with the
  port's forward within 2e-4 (the full-width parity tolerance).
* Run state: two tiny iterations in one run against one iteration and a
  second one resumed in a fresh ``MatInvent``: equal ``metrics.csv`` rows
  (timings excepted), a bitwise equal agent, equal memory and replay.
* Async sampling: iteration 1's crystals equal a synchronous sample from
  the pre-fine-tune-0 weights with the same generator state.
"""
from __future__ import annotations

import csv
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack as msgpack_pkg
import numpy as np
import pytest
import torch
from flax import serialization

from matinvent_tpu.models.mattergen.diffusion import MGNoised as JaxNoised
from matinvent_tpu.models.suite.mattergen import MatterGenSuite as JaxSuite
from matinvent_tpu_torch.models.mattergen.diffusion import MGNoised
from matinvent_tpu_torch.models.suite.mattergen import (
    MatterGenSuite,
    load_model,
    params_from_jax,
    save_model,
)
from matinvent_tpu_torch.pipeline import mat_invent
from matinvent_tpu_torch.pipeline.logger import CSVLogger
from matinvent_tpu_torch.utils import checkpoint, msgpack

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "experiments/results/rl_hhi_rich5/models/final"
FIELDS = ("t", "time_emb", "types", "frac", "lattice")

TINY = [
    "model.model_path=null", "model.model_cfg.hidden_dim=32", "model.model_cfg.num_layers=2",
    "model.model_cfg.time_dim=16", "model.model_cfg.timesteps=10",
    "model.model_cfg.sample_clip=15.0", "model.finetune_cfg.timesteps=10",
    "pipeline.finetune_cfg.accum_steps=5", "pipeline.finetune_cfg.epochs=1",
    "model.sample_cfg.batch_size=6", "pipeline.replay_args.seed=3",
    # an untrained model gives almost no valid samples: the filter is off
    "pipeline.sample_cfg.invalid_filter=false",
]


def tiny(out, rl_epoch: int, *extra: str) -> mat_invent.MatInvent:
    cfg = mat_invent.resolve("rl_hhi_rich5", rl_epoch, [*TINY, *extra])
    return mat_invent.build(cfg, str(out), device="cpu")


# ------------------------------------------------------------------ msgpack


def test_msgpack_encoder_writes_msgpack_and_flax_bytes():
    objs = [None, True, False, 0, 127, 128, 2**16, 2**33, -1, -32, -33, -200, -2**40, 1.25,
            "", "a" * 31, "b" * 32, "c" * 70000, b"", b"x" * 300, [], list(range(16)),
            (1, "x"), {str(i): i for i in range(20)}]
    for obj in objs:
        assert msgpack.packb(obj) == msgpack_pkg.packb(obj, use_bin_type=True)
    rng = np.random.default_rng(0)
    tree = {"params": {"dense": {"kernel": rng.normal(size=(3, 5)).astype(np.float32),
                                 "bias": np.zeros(5, np.float32)},
                       "emb": {"embedding": rng.normal(size=(70000,)).astype(np.float32)},
                       "count": np.int32(7), "empty": np.zeros((0, 2), np.float32)}}
    assert msgpack.packb(tree) == serialization.to_bytes(tree)


def _assert_trees_equal(a, b, path=()):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], (*path, k))
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def _noised(B, A, time_dim, seed=0):
    rng = np.random.default_rng(seed)
    na = rng.integers(1, A + 1, (B,)).astype(np.int32)
    return dict(
        t=np.full((B,), 0.5, np.float32),
        time_emb=rng.normal(size=(B, time_dim)).astype(np.float32),
        types=rng.integers(0, 100, (B, A)).astype(np.int32),
        frac=rng.uniform(size=(B, A, 3)).astype(np.float32),
        lattice=(np.eye(3)[None] * 4.0 + rng.normal(size=(B, 3, 3)) * 0.3).astype(np.float32),
        num_atoms=na, mask=np.arange(A)[None, :] < na[:, None],
    )


def test_params_msgpack_of_the_archived_checkpoint_is_the_jax_tree(tmp_path):
    """Full width: the port reads the archived checkpoint, writes it again,
    and its ``params.msgpack`` restores to the archived one's tree bit for
    bit; the JAX suite loads the port's directory, and the nets agree."""
    model = load_model(CKPT, device="cpu")
    save_model(model, tmp_path / "port")
    ours = serialization.msgpack_restore((tmp_path / "port/params.msgpack").read_bytes())
    ref = serialization.msgpack_restore((CKPT / "params.msgpack").read_bytes())
    _assert_trees_equal(ours, ref)
    jd, params = JaxSuite(model_path=str(tmp_path / "port")).load_model()
    x = _noised(B=2, A=6, time_dim=model.config.time_dim, seed=1)
    ref_out = jax.jit(lambda p: jd.apply_net(
        p, JaxNoised(*(jnp.asarray(x[k]) for k in FIELDS)),
        jnp.asarray(x["num_atoms"]), jnp.asarray(x["mask"])))(params)
    with torch.no_grad():
        out = model.apply_net(MGNoised(*(torch.from_numpy(x[k]) for k in FIELDS)),
                              torch.from_numpy(x["num_atoms"]), torch.from_numpy(x["mask"]))
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref_out[k]), atol=2e-4, rtol=0, err_msg=k)


def test_params_msgpack_of_a_conditional_model_equals_the_jax_suites(tmp_path):
    cfg = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8,
               condition_stats=(("dft_band_gap", 1.5, 0.7),))
    jsuite = JaxSuite(model_name="mattergen_dft_band_gap", model_cfg=cfg)
    params = jsuite.diffusion.init_params(jax.random.PRNGKey(3), batch_size=2, max_atoms=4)
    jsuite.save_model(params, str(tmp_path / "jax"))
    suite = MatterGenSuite(model_name="mattergen_dft_band_gap", model_cfg=cfg, device="cpu")
    model = suite.load_model()
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    suite.save_model(model, tmp_path / "port")
    _assert_trees_equal(
        serialization.msgpack_restore((tmp_path / "port/params.msgpack").read_bytes()),
        serialization.msgpack_restore((tmp_path / "jax/params.msgpack").read_bytes()),
    )
    _, back = JaxSuite(model_name="mattergen_dft_band_gap", model_cfg=cfg,
                       model_path=str(tmp_path / "port")).load_model()
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- run state


def _rows(path):
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    return [{k: v for k, v in r.items() if not k.startswith("time_")} for r in rows]


def _assert_tables_equal(a: list, b: list):
    assert len(a) == len(b)
    for r, q in zip(a, b):
        assert list(r) == list(q)
        for k, v in r.items():
            if k == "struc":
                for f in ("lattice", "species", "frac_coords"):
                    np.testing.assert_array_equal(getattr(v, f), getattr(q[k], f))
            elif k == "data":
                assert list(v) == list(q[k])
                for f, x in v.items():
                    np.testing.assert_array_equal(x, q[k][f])
                    assert np.asarray(x).dtype == np.asarray(q[k][f]).dtype
            else:
                assert v == q[k], k


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    whole = tiny(tmp_path / "whole", 2)
    whole.run_rl()
    first = tiny(tmp_path / "split", 1)
    first.run_rl()
    saved = {k: v.clone() for k, v in first.agent.state_dict().items()}
    resumed = tiny(tmp_path / "split", 2, "pipeline.resume=true")
    assert resumed._start_step == 1 and resumed.cost == first.cost
    for k, v in resumed.agent.state_dict().items():
        assert torch.equal(v, saved[k]), k
    _assert_tables_equal(resumed.ltm.memory, first.ltm.memory)
    _assert_tables_equal(resumed.replay.buffer, first.replay.buffer)
    assert resumed.ltm.unique_comps == first.ltm.unique_comps
    resumed.run_rl()
    assert _rows(tmp_path / "whole/metrics.csv") == _rows(tmp_path / "split/metrics.csv")
    assert len(_rows(tmp_path / "split/metrics.csv")) == 2
    for k, v in whole.agent.state_dict().items():
        assert torch.equal(v, resumed.agent.state_dict()[k]), k
    _assert_tables_equal(whole.ltm.memory, resumed.ltm.memory)
    _assert_tables_equal(whole.replay.buffer, resumed.replay.buffer)
    final = load_model(tmp_path / "split/models/final", device="cpu")
    for k, v in whole.agent.state_dict().items():
        assert torch.equal(final.state_dict()[k], v), k


def test_state_save_freq_saves_every_kth_and_the_last_step(tmp_path, monkeypatch):
    steps = []
    real = mat_invent.save_run_state

    def record(state_dir, agent, step, *args, **kw):
        steps.append(step)
        real(state_dir, agent, step, *args, **kw)

    monkeypatch.setattr(mat_invent, "save_run_state", record)
    tiny(tmp_path, 3, "pipeline.state_save_freq=2").run_rl()
    assert steps == [1, 2]
    assert tiny(tmp_path, 3, "pipeline.resume=true")._start_step == 3


def test_resume_without_state_starts_fresh_and_a_torn_state_raises(tmp_path, caplog):
    with caplog.at_level(logging.INFO):
        pipe = tiny(tmp_path / "fresh", 1, "pipeline.resume=true")
    assert pipe._start_step == 0
    assert "no run state found; starting fresh" in caplog.text
    pipe.run_rl()
    state = tmp_path / "fresh/state"
    assert sorted(p.name for p in state.iterdir()) == sorted(
        [checkpoint.AGENT_FILE, checkpoint.TABLES_FILE, checkpoint.STATE_FILE])
    # the tables of another step: refused
    with np.load(state / checkpoint.TABLES_FILE) as z:
        arrays = dict(z)
    arrays["__step__"] = np.array(5)
    np.savez(state / checkpoint.TABLES_FILE, **arrays)
    with pytest.raises(ValueError, match="torn"):
        tiny(tmp_path / "fresh", 2, "pipeline.resume=true")


def test_generator_states_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    text = checkpoint.generator_state(gen)
    expect = torch.rand(7, generator=gen)
    other = torch.Generator().manual_seed(0)
    checkpoint.set_generator_state(other, text)
    assert torch.equal(torch.rand(7, generator=other), expect)
    assert checkpoint.generator_state(None) is None


def test_csv_logger_appends_to_an_existing_file(tmp_path):
    first = CSVLogger(str(tmp_path))
    first.log({"a": 1.5, "b": float("nan")}, step=0)
    first.log({"a": 2.0, "c": "x"}, step=1)
    text = (tmp_path / "metrics.csv").read_text()
    second = CSVLogger(str(tmp_path))
    second.log({"a": 3.0, "d": 4}, step=2)
    lines = (tmp_path / "metrics.csv").read_text().splitlines()
    assert lines[0] == "a,b,step,c,d"
    assert lines[1:3] == [line + "," for line in text.splitlines()[1:]]
    assert lines[3] == "3.0,,2,,4"


# ------------------------------------------------------------ async, profile


def test_async_iteration_samples_from_the_pre_finetune_weights(tmp_path):
    pipe = tiny(tmp_path / "async", 2, "pipeline.async_sampling=true")
    ref = tiny(tmp_path / "sync", 2)
    start = {k: v.clone() for k, v in pipe.agent.state_dict().items()}
    seen = []
    sample_step = pipe.sample_step

    def capture():
        out = sample_step()
        seen.append(out[1])
        return out

    pipe.sample_step = capture
    pipe.run_rl()
    assert pipe._pending is None and pipe._sampling_pool._shutdown
    # the reference samples twice from the start weights with the same
    # generator stream: its second batch is iteration 1's
    ref.agent.load_state_dict(start)
    _, expect0 = ref.sampler.generate(ref.agent, batch_size=6, num_batches=1)
    gen_state = checkpoint.generator_state(ref.sampler._generator)
    rng_state = ref.sampler._rng.bit_generator.state
    _, expect1 = ref.sampler.generate(ref.agent, batch_size=6, num_batches=1)
    for got, expect in zip(seen, (expect0, expect1)):
        assert len(got) == len(expect)
        for a, b in zip(got, expect):
            np.testing.assert_array_equal(a.lattice, b.lattice)
            np.testing.assert_array_equal(a.frac_coords, b.frac_coords)
            np.testing.assert_array_equal(a.species, b.species)
    # the same draws from the fine-tuned weights differ: the test can tell
    ref.agent.load_state_dict(pipe.agent.state_dict())
    checkpoint.set_generator_state(ref.sampler._generator, gen_state)
    ref.sampler._rng.bit_generator.state = rng_state
    _, moved = ref.sampler.generate(ref.agent, batch_size=6, num_batches=1)
    assert any(not np.array_equal(a.lattice, b.lattice) for a, b in zip(moved, expect1))


def test_async_sampling_reraises_the_workers_exception(tmp_path):
    pipe = tiny(tmp_path, 2, "pipeline.async_sampling=true")
    launch, calls = pipe.sampler.launch, []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("sampling failed in the worker")
        return launch(*args, **kw)

    pipe.sampler.launch = failing
    with pytest.raises(RuntimeError, match="sampling failed in the worker"):
        pipe.run_rl()


def test_ddpo_raises_and_ddpo_with_async_is_refused(tmp_path):
    """DDPO with async sampling is refused; DDPO alone, ported since, builds
    a pipeline whose sampler records its trajectories."""
    with pytest.raises(ValueError, match="async_sampling"):
        tiny(tmp_path, 1, 'pipeline.finetune_mode="ddpo"', "pipeline.async_sampling=true")
    pipe = tiny(tmp_path, 1, 'pipeline.finetune_mode="ddpo"')
    assert pipe.ddpo is not None and pipe.sampler.record_trajectories


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    tiny(tmp_path / "run", 1, f'pipeline.profile_dir="{tmp_path / "prof"}"').run_rl()
    traces = list((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 1000
    assert traces[0].read_text().lstrip().startswith("{")


def test_opt_filter_runs_in_the_loop_and_logs_its_metrics(tmp_path):
    pipe = tiny(tmp_path, 1, "pipeline.sample_cfg.invalid_filter=false",
                'pipeline.sample_cfg.filter={"metrics": ["unique", "novel"], '
                '"relax": false, "structure_matcher": "fast"}')
    pipe.run_rl()
    row = pipe.logger.rows[-1]
    assert row["frac_unique"] > 0 and row["frac_novel"] == 1.0 and row["frac_validity"] >= 0

