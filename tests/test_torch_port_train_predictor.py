"""The port's predictor-training CLI (``matinvent_tpu_torch.tools.train_predictor``)
against the JAX package's ``tools/train_predictor.py``, on the CPU.

20 steps at h32/L2 on 80 corpus structures with numpy-seeded labels: JAX's
``PropertyGNN`` loads the port's ``<model_name>.msgpack`` and predicts every
held-out structure within 1e-5 of ``y_std`` of the port's own prediction
(the tolerance of the port's predictor tests); ``.meta.txt`` has JAX's keys
in JAX's order; the held-out tenth is JAX's (the same numpy permutation);
the defaults of the ``key=value`` arguments are JAX's; without a card and
without ``device=cpu`` the tool refuses to start.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from matinvent_tpu.chem.structure import read_extxyz as jax_read_extxyz
from matinvent_tpu.rewards.calculators.predictor import PropertyGNN as JaxGNN
from matinvent_tpu_torch.chem.structure import read_extxyz, save_extxyz
from matinvent_tpu_torch.rewards.calculators.predictor import PropertyGNN
from matinvent_tpu_torch.tools import train_predictor as tool

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "experiments" / "data" / "corpus_r5.extxyz"
N, STEPS, H, L = 80, 20, 32, 2
STD_TOL = 1e-5
JAX_META_KEYS = ["val_r2", "val_mae", "steps", "y_mean", "y_std", "labels"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_predictor")
    strucs = read_extxyz(str(CORPUS), limit=N)
    save_extxyz(strucs, str(d / "data.extxyz"))
    labels = np.random.default_rng(4).normal(2.0, 0.7, N)
    labels[5] = np.nan  # a missing label is left out of training, as in JAX
    np.savetxt(d / "labels.txt", labels)
    rec = tool.main([f"data={d / 'data.extxyz'}", f"labels={d / 'labels.txt'}",
                     "model_name=mp_bandgap", f"output_dir={d / 'out'}", f"steps={STEPS}",
                     "batch_size=16", f"hidden_dim={H}", f"num_layers={L}", "seed=3",
                     "device=cpu"])
    return d, rec, labels


def test_the_checkpoint_loads_in_jax_and_predicts_as_the_port(run):
    d, rec, _ = run
    assert np.all(np.isfinite(rec["losses"]))
    jgnn = JaxGNN("mp_bandgap", model_dir=str(d / "out"), hidden_dim=H, num_layers=L)
    gnn = PropertyGNN("mp_bandgap", model_dir=d / "out", hidden_dim=H, num_layers=L, device="cpu")
    assert jgnn.loaded and gnn.loaded
    assert (jgnn.y_mean, jgnn.y_std) == (gnn.y_mean, gnn.y_std) == (rec["y_mean"], rec["y_std"])
    held = rec["val_index"]
    ours = gnn.predict([read_extxyz(str(d / "data.extxyz"))[i] for i in held])
    ref = jgnn.predict([jax_read_extxyz(str(d / "data.extxyz"))[i] for i in held])
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=STD_TOL * gnn.y_std)


def test_meta_has_jax_keys_and_the_split_is_jax(run):
    d, rec, labels = run
    lines = (d / "out" / "mp_bandgap.meta.txt").read_text().splitlines()
    meta = dict(line.split("=", 1) for line in lines)
    assert list(meta) == JAX_META_KEYS
    assert meta["steps"] == str(STEPS) and meta["labels"] == str(d / "labels.txt")
    assert float(meta["val_r2"]) == pytest.approx(rec["val_r2"], abs=1e-5)
    finite = labels[np.isfinite(labels)]
    assert float(meta["y_mean"]) == finite.mean() and float(meta["y_std"]) == finite.std()
    # JAX's split: numpy's permutation of the structures from the seed
    perm = np.random.default_rng(3).permutation(N)
    assert rec["val_index"] == perm[: N // 10].tolist()


def test_arguments_default_as_jax(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(tool, "train", lambda s, y, **kw: seen.update(kw) or kw)
    monkeypatch.setattr(tool, "read_extxyz", lambda path: [None])
    monkeypatch.setattr(tool.np, "loadtxt", lambda path: np.zeros(1))
    tool.main(["data=x.extxyz", "labels=y.txt", "device=cpu"])
    assert seen == dict(model_name="mp_bandgap", output_dir="predictors", steps=5000,
                        batch_size=64, lr=1e-3, max_atoms=32, seed=0, hidden_dim=128,
                        num_layers=4, label_source="y.txt", device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["data=x.extxyz", "labels=y.txt"])
