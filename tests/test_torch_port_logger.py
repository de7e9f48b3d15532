"""The port's metric loggers against the JAX package's
(``matinvent_tpu/pipeline/logger.py``), on the CPU.

A fake ``wandb`` module in ``sys.modules`` records every call; the port's
``WandBLogger`` must make exactly the calls JAX's makes for the same
constructor arguments and method calls (``init`` with ``config=`` and extra
keyword arguments, ``watch``, ``log``, ``log_summary``,
``mark_preempting``, ``log_artifact``, ``finish``). The base and CSV
loggers take ``config=`` and keep it, and their ``log_summary`` and
``finish`` do nothing, as JAX's.
"""
from __future__ import annotations

import sys
import types

import pytest

from matinvent_tpu.pipeline import logger as jax_logger
from matinvent_tpu_torch.pipeline import logger as port_logger


def _fake_wandb(calls: list):
    mod = types.ModuleType("wandb")

    def rec(name):
        def fn(*args, **kwargs):
            calls.append((name, args, kwargs))
        return fn

    class Summary(dict):
        def __setitem__(self, k, v):
            calls.append(("summary", (k, v), {}))
            super().__setitem__(k, v)

    class Artifact:
        def __init__(self, name, type):
            calls.append(("Artifact", (), dict(name=name, type=type)))

        def add_file(self, path):
            calls.append(("Artifact.add_file", (path,), {}))

        def save(self):
            calls.append(("Artifact.save", (), {}))

    for name in ("init", "watch", "log", "mark_preempting", "finish"):
        setattr(mod, name, rec(name))
    mod.run = types.SimpleNamespace(summary=Summary())
    mod.Artifact = Artifact
    return mod


def _drive(module, monkeypatch) -> list:
    calls: list = []
    monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(calls))
    lg = module.WandBLogger("run-a", "proj", entity="team", group="g1", mode="offline",
                            config={"lr": 1e-4, "reward": "hhi"}, tags=["x"], resume="allow")
    lg.watch("model-object", log="gradients", log_freq=50)
    lg.log({"reward mean": 0.5, "valid": 12}, step=3)
    lg.log({"loss": 1.25}, step=4, split="train")
    lg.log_summary({"best": 0.9, "iters": 60})
    lg.mark_preempting()
    lg.log_artifact("agent", "model", "/some/file.msgpack")
    lg.finish()
    assert lg.config == {"lr": 1e-4, "reward": "hhi"}
    return calls


def test_wandb_logger_makes_jax_calls(monkeypatch):
    ours = _drive(port_logger, monkeypatch)
    ref = _drive(jax_logger, monkeypatch)
    assert ours == ref
    assert [c[0] for c in ours] == ["init", "watch", "log", "log", "summary", "summary",
                                    "mark_preempting", "Artifact", "Artifact.add_file",
                                    "Artifact.save", "finish"]


def test_wandb_logger_without_wandb_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError, match="logger=csv"):
        port_logger.WandBLogger("a", "b")


def test_base_and_csv_loggers_take_config_and_do_nothing_at_summary(tmp_path):
    for module in (port_logger, jax_logger):
        base = module.Logger(config={"a": 1})
        assert base.config == {"a": 1}
        assert base.log_summary({"x": 1}) is None and base.finish() is None
        assert base.log({"x": 1}, step=0, split="s") == {"s/x": 1}
        d = tmp_path / module.__name__.split(".")[0]
        csv = module.CSVLogger(str(d), config={"b": 2}, unused=True)
        assert csv.config == {"b": 2}
        csv.log({"x": 1.5}, step=0)
        csv.log_summary({"best": 1})
        csv.finish()
    assert ((tmp_path / "matinvent_tpu_torch" / "metrics.csv").read_text().splitlines()
            == (tmp_path / "matinvent_tpu" / "metrics.csv").read_text().splitlines())
