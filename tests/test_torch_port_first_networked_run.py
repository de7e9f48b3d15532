"""Offline rehearsal of ``matinvent_tpu_torch.tools.first_networked_run``, on
the CPU with sockets blocked (as ``tests/test_first_networked_run.py``
rehearses the JAX tool).

Every network touchpoint is a stand-in on disk, built by the JAX test's own
fixtures: ``huggingface_hub.snapshot_download`` returns a fake snapshot in
the ``prop_pred/alignn/<task>/`` layout, ``hf_hub_download`` a fake
GemNet-style ``last.ckpt`` whose teacher lives in a fake ``mattergen`` wheel
(with ``hydra``) put on ``sys.path`` and ``PYTHONPATH``, and the DGL
``alignn``/``jarvis`` stack is a stub. Sockets are blocked in this process
and, through a ``sitecustomize`` on ``PYTHONPATH``, in the distillation's
subprocess: nothing is downloaded. All four stages run with
``device=cpu``; the table feeds the port's ``num_atoms_distribution_file``
reader; the stages skip on a second call; ``plan=1`` prints the plan and
does nothing; ``rl_smoke`` needs ``distill`` first; the wheel-missing
message names the wheel; ``<stage>.<key>=`` overrides reach their stage
only.
"""
from __future__ import annotations

import json
import os
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_first_networked_run as jax_rehearsal
from matinvent_tpu_torch.models.mattergen.sample import MatterGenSampler
from matinvent_tpu_torch.tools import distill_mattergen
from matinvent_tpu_torch.tools import first_networked_run as fnr

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SITE_BLOCK = """\
import socket


def _refused(*args, **kwargs):
    raise OSError("network access is blocked in this rehearsal")


socket.socket.connect = _refused
socket.socket.connect_ex = _refused
socket.create_connection = _refused
socket.getaddrinfo = _refused
"""


def _refused(*args, **kwargs):
    raise OSError("network access is blocked in this rehearsal")


@pytest.fixture
def offline(tmp_path, monkeypatch):
    """Sockets blocked here and in subprocesses; the fake wheel importable."""
    for name in ("connect", "connect_ex"):
        monkeypatch.setattr(socket.socket, name, _refused)
    monkeypatch.setattr(socket, "create_connection", _refused)
    monkeypatch.setattr(socket, "getaddrinfo", _refused)
    wheel = tmp_path / "fakewheel"
    for rel, src in jax_rehearsal._FAKE_WHEEL_FILES.items():
        p = wheel / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    (wheel / "sitecustomize.py").write_text(SITE_BLOCK)
    before = set(sys.modules)
    monkeypatch.syspath_prepend(str(wheel))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(wheel), str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(fnr, "OUT", str(tmp_path / "fnr"))
    yield tmp_path
    for name in [n for n in sys.modules if n not in before
                 and (n.startswith("mattergen") or n.startswith("hydra"))]:
        del sys.modules[name]


def test_all_four_stages_offline_on_the_cpu(offline, monkeypatch, capsys):
    tmp_path = offline
    with pytest.raises(OSError, match="blocked"):
        socket.create_connection(("example.org", 443))
    snap = jax_rehearsal._fake_hf_snapshot(str(tmp_path / "hf_snapshot"))
    teacher = jax_rehearsal._fake_gemnet_ckpt(str(tmp_path / "last.ckpt"))
    corpus = jax_rehearsal._tiny_corpus(str(tmp_path / "corpus.extxyz"))
    import huggingface_hub

    monkeypatch.setattr(huggingface_hub, "snapshot_download",
                        lambda repo, allow_patterns=None: snap)
    monkeypatch.setattr(huggingface_hub, "hf_hub_download", lambda repo, fn: teacher)
    jax_rehearsal._fake_dgl_stack(monkeypatch)

    # alex_table: its JSON feeds the port's num_atoms_distribution_file reader
    fnr.main(["stages=alex_table", "device=cpu"])
    table = os.path.join(fnr.OUT, "num_atoms_distributions.json")
    sampler = MatterGenSampler(batch_size=8, num_batches=1, max_atoms=6,
                               num_atoms_distribution="ALEX_MP_20",
                               num_atoms_distribution_file=table, seed=0)
    assert set(np.unique(sampler._draw_num_atoms(64))) <= {2, 4, 6}

    # alignn_golden: the port's ALIGNN on the fake snapshot, the stub DGL side
    fnr.main(["stages=alignn_golden", "device=cpu"])
    with open(os.path.join(fnr.OUT, "alignn_goldens.json")) as fh:
        goldens = json.load(fh)
    for task in ("band_gap", "formation_energy", "bulk_modulus"):
        vals = goldens["native"][task]
        assert isinstance(vals, list) and len(vals) == 3 and np.all(np.isfinite(vals)), (task, vals)
    assert goldens["dgl_reference"]["band_gap"] == [0.5, 0.5, 0.5]

    # distill: the wheel builder in a subprocess with sockets blocked
    fnr.main(["stages=distill", "distill.steps=40", "distill.batch=8", "distill.hidden=16",
              "distill.layers=1", "distill.timesteps=8", "distill.max_atoms=6",
              f"distill.corpus={corpus}", "device=cpu"])
    dist_dir = Path(fnr.OUT) / "distilled_mattergen_base"
    assert (dist_dir / "params.msgpack").is_file()
    assert "heldout" in json.dumps(json.loads((dist_dir / "distill_summary.json").read_text()))

    # rl_smoke: one iteration of the port's main, distilled model, ALIGNN reward
    monkeypatch.setenv("ALIGNN_MODEL_DIR", snap)
    cwd = os.getcwd()
    try:
        fnr.main(["stages=rl_smoke", "device=cpu", "rl_smoke.overrides="
                  "model.finetune_cfg.timesteps=8;pipeline.finetune_cfg.accum_steps=4"])
    finally:
        os.chdir(cwd)
    run_dir = Path(fnr.OUT) / "rl_smoke"
    assert (run_dir / "metrics.csv").is_file() and (run_dir / "hparams.yaml").is_file()

    # every stage skips on a second call
    capsys.readouterr()
    fnr.main(["stages=alex_table,alignn_golden,distill", "device=cpu"])
    assert capsys.readouterr().out.count("exists; skip") == 3


def test_plan_prints_the_plan_and_does_nothing(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(fnr, "OUT", str(tmp_path / "fnr"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fnr.main(["plan=1"])  # no card needed for the plan
    out = capsys.readouterr().out
    assert "alex_table" in out and "rl_smoke" in out and "plan=1" in out
    assert not (tmp_path / "fnr").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fnr.main(["stages=alex_table"])


def test_rl_smoke_requires_distill_first(tmp_path, monkeypatch):
    monkeypatch.setattr(fnr, "OUT", str(tmp_path / "fnr"))
    with pytest.raises(SystemExit, match="run stage `distill` first"):
        fnr.stage_rl_smoke({}, "cpu")


def test_wheel_builder_failure_message_names_the_wheel():
    """Without the wheel the builder says what to install."""
    assert "mattergen" not in sys.modules
    with pytest.raises(ImportError, match="external `mattergen` wheel"):
        distill_mattergen._builder_mattergen_wheel({"lightning_module": {}}, {})


def test_stage_opts_routing(monkeypatch):
    """``<stage>.<key>=<value>`` reaches that stage only, with the device."""
    seen = {}
    monkeypatch.setattr(fnr, "STAGES", {
        "a": lambda opts, device: seen.setdefault("a", (opts, device)),
        "b": lambda opts, device: seen.setdefault("b", (opts, device)),
    })
    fnr.main(["stages=a,b", "a.x=1", "b.y=2", "b.z=3", "device=cpu"])
    assert seen == {"a": ({"x": "1"}, "cpu"), "b": ({"y": "2", "z": "3"}, "cpu")}
