"""The port's device-side reward models against the JAX package's, on the CPU.

* The msgpack reader against ``flax.serialization.msgpack_restore`` on the
  six predictor checkpoints, and against the port's writer on random trees.
* The ten ``PropertyPredictor`` tasks on the in-repo weights against JAX on
  the first 128 structures of ``experiments/data/corpus_r5.extxyz`` and six
  degenerate ones: NaN and inf at the same places, each model's output
  within 1e-5 of its ``y_std`` (measured: at most 1.9e-6). Each task from
  each side's own predictions within 1e-5 relative (the derived tasks are
  products and powers of two predictions), and bit for bit from the same
  predictions.
* Random weights carried from JAX (H=16, L=1), the legacy and mismatched
  checkpoints; ``CSPNet``'s lattice/coord/type heads, relaxed one-hot
  input and ``pred_type`` against the JAX ``CSPNet`` (1e-5, measured
  1.9e-6); SynScore (fallback embedding bitwise, scores within 1e-6 on
  the npz, random and ``.pth.tar`` ensembles); the ``synthesizable`` screen
  of ``OptFilter``; one ``PredictorTrainer`` step against optax; a
  port-trained checkpoint in the JAX ``PropertyGNN``; ``proxy_labels``
  exactly.
* The recipe ``rl_mag_rich_dense`` and the new reward sections against
  their YAML; tiny CPU iterations of the entry point on predictor rewards;
  ``pretrained_geneval_r4`` against JAX's f32 net.
* The committed JAX values that ``chip_smoke.py`` holds the card against
  (``matinvent_tpu_torch/experiments/results/reward_models_jax.json``)
  recomputed in part. ``python tests/test_torch_port_rewards.py`` writes
  that file anew.
"""
from __future__ import annotations

import csv
import json
import math
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from matinvent_tpu.chem.proxy_labels import LABEL_FNS as JAX_LABEL_FNS  # noqa: E402
from matinvent_tpu.chem.proxy_labels import label_structures as jax_label_structures  # noqa: E402
from matinvent_tpu.chem.structure import Structure as JaxStructure  # noqa: E402
from matinvent_tpu.models.mattergen.diffusion import MGNoised as JaxNoised  # noqa: E402
from matinvent_tpu.models.suite.mattergen import MatterGenSuite as JaxSuite  # noqa: E402
from matinvent_tpu.parallel.train_predictor import PredictorTrainer as JaxTrainer  # noqa: E402
from matinvent_tpu.parallel.train_predictor import labeled_batches as jax_batches  # noqa: E402
from matinvent_tpu.pipeline.filters import OptFilter as JaxOptFilter  # noqa: E402
from matinvent_tpu.rewards.calculators.predictor import PropertyGNN as JaxGNN  # noqa: E402
from matinvent_tpu.rewards.calculators.predictor import (  # noqa: E402
    PropertyPredictor as JaxPredictor,
)
from matinvent_tpu.rewards.calculators.syn_score import SynScore as JaxSynScore  # noqa: E402
from matinvent_tpu.rewards.calculators.syn_score import (  # noqa: E402
    _fallback_element_embedding as jax_fallback,
)
from matinvent_tpu_torch.chem.data import SYMBOLS  # noqa: E402
from matinvent_tpu_torch.chem.proxy_labels import LABEL_FNS, label_structures  # noqa: E402
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz  # noqa: E402
from matinvent_tpu_torch.experiments import train_predictor  # noqa: E402
from matinvent_tpu_torch.models.mattergen.diffusion import MGNoised  # noqa: E402
from matinvent_tpu_torch.models.suite.mattergen import load_model, params_from_jax  # noqa: E402
from matinvent_tpu_torch.parallel.train_predictor import (  # noqa: E402
    PredictorTrainer,
    labeled_batches,
)
from matinvent_tpu_torch.pipeline import mat_invent  # noqa: E402
from matinvent_tpu_torch.pipeline.filters import OptFilter  # noqa: E402
from matinvent_tpu_torch.recipes import RECIPES, REWARDS  # noqa: E402
from matinvent_tpu_torch.rewards.calculators.predictor import (  # noqa: E402
    DEFAULT_MODEL_DIR,
    TASK_MODEL_DICT,
    PropertyGNN,
    PropertyPredictor,
)
from matinvent_tpu_torch.rewards.calculators.syn_score import (  # noqa: E402
    SynScore,
    fallback_element_embedding,
)
from matinvent_tpu_torch.utils import msgpack  # noqa: E402
from matinvent_tpu_torch.utils.config import read_flat_yaml  # noqa: E402

torch.set_num_threads(1)

CORPUS = ROOT / "experiments/data/corpus_r5.extxyz"
FIXTURE = ROOT / "matinvent_tpu_torch/experiments/results/reward_models_jax.json"
N_CORPUS = 128
MODELS = sorted(v for v in TASK_MODEL_DICT.values() if v)
TASKS = list(TASK_MODEL_DICT)
# each model's output against JAX, in units of its y_std; a task's, relative
# and in units of its largest value (task_tol)
STD_TOL, DERIVED_RTOL = 1e-5, 1e-5


def corpus_head(n: int) -> list[Structure]:
    """The first ``n`` structures of the corpus."""
    return read_extxyz(str(CORPUS), limit=n)


def degenerate(base: Structure) -> list[dict]:
    """Structures a sampler can emit that the predictors must refuse or
    survive: a 2x2x2 supercell past the 32-atom cap, a zero-volume cell,
    species 101 and 0, a NaN cell, and a single atom."""
    shifts = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], float)
    sup = dict(lattice=base.lattice * 2,
               species=np.tile(base.species, 8),
               frac_coords=((base.frac_coords[None] + shifts[:, None]) / 2).reshape(-1, 3))
    flat = dict(lattice=np.diag([4.0, 5.0, 0.0]), species=np.array([26, 8]),
                frac_coords=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]))
    return [
        sup, flat,
        dict(flat, lattice=np.eye(3) * 4.0, species=np.array([101, 8])),
        dict(flat, lattice=np.eye(3) * 4.0, species=np.array([0, 8])),
        dict(flat, lattice=np.full((3, 3), np.nan)),
        dict(lattice=np.eye(3) * 2.5, species=np.array([26]), frac_coords=np.zeros((1, 3))),
    ]


def structures_of(records: list[dict]) -> list[Structure]:
    return [Structure(np.asarray(r["lattice"], float), np.asarray(r["species"]),
                      np.asarray(r["frac_coords"], float)) for r in records]


def to_jax(strucs: list[Structure]) -> list[JaxStructure]:
    return [JaxStructure(s.lattice, s.species, s.frac_coords) for s in strucs]


def syn_ok(strucs) -> np.ndarray:
    """The structures SynScore can read (species within the tables)."""
    return np.array([bool(((s.species >= 0) & (s.species <= 100)).all()) for s in strucs])


def _json_floats(a) -> list:
    return [float(v) for v in np.asarray(a, float)]


def jax_reference(strucs: list[Structure], tmp: Path) -> dict:
    """The JAX package's values on ``strucs``: each predictor's raw
    prediction and ``y_std``, the ten tasks, and SynScore (NaN where SynScore
    cannot read the species)."""
    js = to_jax(strucs)
    calc = JaxPredictor(str(tmp / "jax_pred"), task="band_gap")
    raw, y_std, tasks = {}, {}, {}
    for task in TASKS:
        calc.task = task
        tasks[task] = _json_floats(calc.calc((js, None), "tmp"))
        name = TASK_MODEL_DICT[task]
        if name:
            m = calc._models[name]
            raw[name], y_std[name] = _json_floats(m.predict(js)), m.y_std
    ok = syn_ok(strucs)
    syn = np.full(len(strucs), np.nan)
    syn[ok] = JaxSynScore(str(tmp / "jax_syn")).calc(([j for j, m in zip(js, ok) if m], None))
    return dict(raw=raw, y_std=y_std, tasks=tasks, syn_score=_json_floats(syn))


def task_tol(ref) -> float:
    """A task's absolute tolerance: ``STD_TOL`` of its largest finite value
    (at least 1)."""
    ref = np.asarray(ref, float)
    return STD_TOL * max(np.abs(ref[np.isfinite(ref)]).max(initial=0.0), 1.0)


def close_with_nans(a, b, atol, rtol=0.0, what=""):
    a, b = np.asarray(a, float), np.asarray(b, float)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{what}: NaN positions")
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=f"{what}: inf positions")
    fin = np.isfinite(a)
    np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=f"{what}: inf signs")
    np.testing.assert_allclose(a[fin], b[fin], atol=atol, rtol=rtol, err_msg=what)


@pytest.fixture(scope="module")
def strucs():
    head = corpus_head(N_CORPUS)
    return head + structures_of(degenerate(head[0]))


# ---------------------------------------------------------------- msgpack


@pytest.mark.parametrize("name", MODELS)
def test_msgpack_reader_restores_predictor_files_as_flax(name):
    blob = (DEFAULT_MODEL_DIR / f"{name}.msgpack").read_bytes()
    ours, ref = msgpack.unpackb(blob), serialization.msgpack_restore(blob)
    mine, theirs = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (ours, ref))
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(mine, theirs):
        assert type(a) is type(b), path
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path


def _random_tree(rng, depth=0):
    leaves = [
        lambda: rng.normal(size=tuple(rng.integers(1, 5, rng.integers(0, 4)))).astype(
            rng.choice(["float32", "float64", "float16"])),
        lambda: rng.integers(-2**40, 2**40, size=(rng.integers(0, 7),)).astype(
            rng.choice(["int8", "int32", "int64", "uint16"])),
        lambda: rng.random((2, 3)) > 0.5,
        lambda: np.float32(rng.normal()),
        lambda: np.int64(rng.integers(-10**12, 10**12)),
        lambda: float(rng.normal()),
        lambda: int(rng.integers(-2**63, 2**63 - 1)),
        lambda: "s" * int(rng.integers(0, 300)),
        lambda: bool(rng.integers(2)),
        lambda: None,
    ]
    n = int(rng.integers(1, 20 if depth == 0 else 6))
    return {
        f"k{i}": (_random_tree(rng, depth + 1) if depth < 3 and rng.random() < 0.3
                  else leaves[int(rng.integers(len(leaves)))]())
        for i in range(n)
    }


def _same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (np.ndarray, np.generic)):
        return (type(a) is type(b) and a.dtype == b.dtype and np.shape(a) == np.shape(b)
                and np.asarray(a).tobytes() == np.asarray(b).tobytes())
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("seed", range(4))
def test_msgpack_reader_round_trips_random_trees(seed):
    tree = _random_tree(np.random.default_rng(seed))
    blob = msgpack.packb(tree)
    assert _same(msgpack.unpackb(blob), tree)
    assert _same(msgpack.unpackb(blob), serialization.msgpack_restore(blob))
    # flax's own bytes of the same tree read back alike
    assert _same(msgpack.unpackb(serialization.msgpack_serialize(tree)), tree)


def test_msgpack_reader_refuses_chunked_arrays_and_garbage():
    blob = msgpack.packb({"a": {msgpack.CHUNKED_ARRAY_KEY: True, "shape": [2]}})
    with pytest.raises(ValueError, match="chunks"):
        msgpack.unpackb(blob)
    with pytest.raises(ValueError):
        msgpack.unpackb(msgpack.packb({"a": 1}) + b"\x00")
    with pytest.raises(ValueError):
        msgpack.unpackb(msgpack.packb({"a": "long string"})[:-3])


# ------------------------------------------------------------- predictors


class _Fixed:
    """A model stand-in that returns fixed predictions (a fresh copy per
    call: the calculator clamps them in place)."""

    def __init__(self, values):
        self.values = np.asarray(values, float)

    def predict(self, structures):
        assert len(structures) == len(self.values)
        return self.values.copy()


def _calc_all(calc, strucs, raw) -> dict:
    """The ten tasks of ``calc`` with its models answering ``raw``."""
    calc._models = {name: _Fixed(v) for name, v in raw.items()}
    out = {}
    for task in TASKS:
        calc.task = task
        out[task] = calc.calc((strucs, None), task)
    return out


@pytest.fixture(scope="module")
def ten_tasks(strucs, tmp_path_factory):
    """Each side's six raw predictions (one predict per model), then each
    side's ten tasks derived from its own predictions."""
    tmp = tmp_path_factory.mktemp("pred")
    port = PropertyPredictor(str(tmp / "port"), device="cpu")
    jax_calc = JaxPredictor(str(tmp / "jax"))
    js = to_jax(strucs)
    tasks = {m: t for t, m in TASK_MODEL_DICT.items() if m}
    models = {name: (port._model(tasks[name]), jax_calc._model(tasks[name])) for name in MODELS}
    raw = {name: (p.predict(strucs), j.predict(js)) for name, (p, j) in models.items()}
    ours = _calc_all(port, strucs, {k: v[0] for k, v in raw.items()})
    theirs = _calc_all(jax_calc, js, {k: v[1] for k, v in raw.items()})
    out = {task: (ours[task], theirs[task]) for task in TASKS}
    return port, models, out, raw


def test_predictors_load_the_in_repo_weights(ten_tasks):
    _, models, _, _ = ten_tasks
    assert sorted(models) == MODELS
    for name, (m, j) in models.items():
        assert m.loaded and j.loaded, name
        assert (m.y_mean, m.y_std) == (j.y_mean, j.y_std)
        assert m.device.type == "cpu"


@pytest.mark.parametrize("name", MODELS)
def test_each_predictor_matches_jax_on_corpus_and_degenerate_structures(ten_tasks, name):
    _, models, _, raw = ten_tasks
    ours, ref = raw[name]
    y_std = models[name][0].y_std
    close_with_nans(ours, ref, atol=STD_TOL * y_std, what=name)
    # the cap, the species range and the NaN cell are refused, the flat
    # cell and the single atom are not
    assert np.isnan(ours[N_CORPUS:N_CORPUS + 6]).tolist() == [True, False, True, True, True, False]
    assert np.isfinite(ours[:N_CORPUS]).all()


@pytest.mark.parametrize("task", TASKS)
def test_each_task_matches_jax(ten_tasks, strucs, task, tmp_path):
    port, _, out, raw = ten_tasks
    ours, ref = out[task]
    # each side from its own predictions: the models' gaps carried through
    # clamps, products and powers
    close_with_nans(ours, ref, atol=task_tol(ref), rtol=DERIVED_RTOL, what=task)
    # from the same predictions the arithmetic is JAX's, bit for bit
    same = _calc_all(JaxPredictor(str(tmp_path / "jax")), to_jax(strucs),
                     {k: v[0] for k, v in raw.items()})[task]
    np.testing.assert_array_equal(ours, same, err_msg=task)
    # the results file the calculator saves
    saved = np.loadtxt(Path(port.root_dir) / f"{task}.txt")
    close_with_nans(saved, ours, atol=6e-9, what=f"{task} file")
    if task == "magnetic_density":
        # the zero-volume cell: a finite moment over no volume
        assert np.isinf(ours[N_CORPUS + 1]) or np.isnan(ours[N_CORPUS + 1])


def test_random_weights_carried_from_jax_and_checkpoint_variants(strucs, tmp_path, caplog):
    H, L = 16, 1
    jgnn = JaxGNN("mp_bandgap", hidden_dim=H, num_layers=L, seed=3)
    gnn = PropertyGNN("mp_bandgap", model_dir="", hidden_dim=H, num_layers=L, device="cpu")
    assert not gnn.loaded and not jgnn.loaded
    sd = params_from_jax(jax.tree.map(np.asarray, jgnn.params), prefix="")
    gnn.net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    js = to_jax(strucs)
    close_with_nans(gnn.predict(strucs), jgnn.predict(js), atol=1e-5, what="random H16")
    # the tree the port writes is the flax tree, leaf for leaf
    tmpl = gnn.template()
    for (p, a), (q, b) in zip(*(jax.tree_util.tree_flatten_with_path(t)[0]
                                for t in (tmpl, jax.tree.map(np.asarray, jgnn.params)))):
        assert p == q and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    # legacy raw params: loaded, no scaler
    (ckpt_dir / "mp_bandgap.msgpack").write_bytes(serialization.to_bytes(jgnn.params))
    for g in (PropertyGNN("mp_bandgap", model_dir=ckpt_dir, hidden_dim=H, num_layers=L,
                          device="cpu"),
              JaxGNN("mp_bandgap", model_dir=str(ckpt_dir), hidden_dim=H, num_layers=L)):
        assert g.loaded and (g.y_mean, g.y_std) == (0.0, 1.0)
    # another width: the tree matches, the leaves do not -> random init kept
    with caplog.at_level("WARNING"):
        g = PropertyGNN("mp_bandgap", model_dir=ckpt_dir, hidden_dim=32, num_layers=L,
                        device="cpu")
        j = JaxGNN("mp_bandgap", model_dir=str(ckpt_dir), hidden_dim=32, num_layers=L)
    assert not g.loaded and not j.loaded
    assert sum("does not match" in r.message for r in caplog.records) == 2
    # another depth: the tree itself differs -> both raise
    with pytest.raises(ValueError):
        PropertyGNN("mp_bandgap", model_dir=ckpt_dir, hidden_dim=H, num_layers=2, device="cpu")
    with pytest.raises(ValueError):
        JaxGNN("mp_bandgap", model_dir=str(ckpt_dir), hidden_dim=H, num_layers=2)


@pytest.mark.parametrize("smooth,pred_type,ln", [(True, True, False), (True, False, True),
                                                 (False, True, True)])
def test_cspnet_heads_match_jax(smooth, pred_type, ln):
    """The lattice/coord/type heads, the relaxed one-hot embedding and
    ``pred_type`` against the JAX ``CSPNet`` (H=16, L=1, f32), with flax
    params carried across: 1e-5 absolute on every output, padded atoms
    included (measured: at most 1.9e-6)."""
    from matinvent_tpu.models.cspnet import CSPNet as JaxCSPNet

    from matinvent_tpu_torch.models.cspnet import CSPNet

    B, A, H, LAT, K = 3, 5, 16, 8, 100
    rng = np.random.default_rng(11)
    num_atoms = np.array([5, 2, 3])
    mask = np.arange(A)[None, :] < num_atoms[:, None]
    types = np.where(mask, rng.integers(1, K + 1, (B, A)), 0)
    feats = (rng.dirichlet(np.ones(K), (B, A)).astype(np.float32) if smooth
             else types.astype(np.int32))
    frac = rng.random((B, A, 3)).astype(np.float32)
    lattice = (np.eye(3) * 4.0 + rng.normal(0, 0.3, (B, 3, 3))).astype(np.float32)
    t_emb = rng.normal(size=(B, LAT)).astype(np.float32)
    args = (t_emb, feats, frac, lattice, num_atoms.astype(np.int32), mask)
    kw = dict(hidden_dim=H, latent_dim=LAT, num_layers=1, max_atoms=K, ln=ln,
              smooth=smooth, pred_type=pred_type)
    jnet = JaxCSPNet(**kw)
    params = jnet.init(jax.random.PRNGKey(5), *(jnp.asarray(a) for a in args))
    ref = jnet.apply(params, *(jnp.asarray(a) for a in args))
    net = CSPNet(**kw)
    sd = params_from_jax(jax.tree.map(np.asarray, params), prefix="")
    net.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ours = net(*(torch.from_numpy(np.asarray(a)) for a in args))
    assert len(ours) == len(ref) == (3 if pred_type else 2)
    for name, a, b in zip(("lattice_out", "coord_out", "type_out"), ours, ref):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0, err_msg=name)


def test_predictor_refuses_unknown_tasks_and_a_missing_weights_dir(tmp_path, monkeypatch):
    with pytest.raises(ValueError):
        PropertyPredictor(str(tmp_path), task="heat_capacity", device="cpu")
    from matinvent_tpu_torch.rewards.calculators import predictor

    monkeypatch.setattr(predictor, "DEFAULT_MODEL_DIR", tmp_path / "missing")
    with pytest.raises(FileNotFoundError, match="model_dir"):
        PropertyPredictor(str(tmp_path), task="band_gap", device="cpu")
    assert not PropertyPredictor(str(tmp_path), model_dir="", device="cpu")._model(
        "band_gap").loaded


# ---------------------------------------------------------------- SynScore


def test_fallback_embedding_is_jax_bitwise():
    for sym in SYMBOLS[1:] + ["Xx"]:
        assert fallback_element_embedding(sym).tobytes() == jax_fallback(sym).tobytes(), sym


def _write_bags(path: Path, n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    path.mkdir()
    for i in range(n):
        sd = {"cgnf_to_fc.weight": torch.tensor(rng.normal(size=(180, 90)) * 0.1, dtype=torch.float32),
              "cgnf_to_fc.bias": torch.tensor(rng.normal(size=180) * 0.1, dtype=torch.float32),
              "fc_out.weight": torch.tensor(rng.normal(size=(2, 180)) * 0.1, dtype=torch.float32),
              "fc_out.bias": torch.tensor(rng.normal(size=2) * 0.1, dtype=torch.float32)}
        torch.save({"state_dict": sd}, path / f"bag_{i:03d}.pth.tar")


@pytest.mark.parametrize("ensemble", ["npz", "random", "pth"])
def test_syn_score_matches_jax(strucs, tmp_path, ensemble):
    model_path = {"npz": None, "random": str(tmp_path / "none.npz"),
                  "pth": str(tmp_path / "bags")}[ensemble]
    if ensemble == "pth":
        _write_bags(tmp_path / "bags", 2, seed=5)
    ok = syn_ok(strucs)
    s = [x for x, m in zip(strucs, ok) if m]
    port = SynScore(str(tmp_path / "p"), model_path=model_path, seed=4, device="cpu")
    ref = JaxSynScore(str(tmp_path / "j"), model_path=model_path, seed=4)
    assert port.trained == ref.trained == (ensemble != "random")
    ours, theirs = port.calc((s, None), "x"), ref.calc((to_jax(s), None), "x")
    close_with_nans(ours, theirs, atol=1e-6, what=ensemble)
    # species 0 has no embedding: NaN on both sides
    assert np.isnan(ours[-3]) and s[-3].species[0] == 0


def test_syn_score_nan_without_an_embedding(strucs, tmp_path):
    emb = {el: fallback_element_embedding(el).tolist() for el in ("O", "Fe", "Li")}
    path = tmp_path / "element_emb.json"
    path.write_text(json.dumps(emb))
    s = [strucs[-1], Structure(np.eye(3) * 4, [3, 8], [[0, 0, 0], [0.5, 0.5, 0.5]]),
         Structure(np.eye(3) * 4, [11, 17], [[0, 0, 0], [0.5, 0.5, 0.5]])]
    ours = SynScore(str(tmp_path), emb_path=str(path), device="cpu").calc((s, None))
    theirs = JaxSynScore(str(tmp_path), emb_path=str(path)).calc((to_jax(s), None))
    assert np.isnan(ours).tolist() == [False, False, True] == np.isnan(theirs).tolist()
    close_with_nans(ours, theirs, atol=1e-6)


@pytest.mark.parametrize("trained", [True, False])
def test_opt_filter_synthesizable_equals_jax(strucs, tmp_path, monkeypatch, trained):
    monkeypatch.chdir(tmp_path)
    s = [x for x, m in zip(strucs[:40], syn_ok(strucs[:40])) if m]
    kw = dict(metrics=["validity", "synthesizable"], structure_matcher="fast", syn_threshold=0.6)
    if trained:
        port, ref = OptFilter(device="cpu", **kw), JaxOptFilter(**kw)
    else:
        port = OptFilter(syn_calculator=SynScore("p", model_path="none.npz", device="cpu"), **kw)
        ref = JaxOptFilter(syn_calculator=JaxSynScore("j", model_path="none.npz"), **kw)
    masks, metrics = port.compute_metrics(s, None)
    jmasks, jmetrics = ref.compute_metrics(to_jax(s), None)
    assert metrics == jmetrics
    assert masks.keys() == jmasks.keys()
    for k in masks:
        np.testing.assert_array_equal(masks[k], jmasks[k], err_msg=k)
    assert ("synthesizable" in masks) == trained
    if trained:
        assert 0 < masks["synthesizable"].sum() < len(s)
        kept, kept_s, _ = port(list(range(len(s))), s)
        assert kept == [i for i in range(len(s)) if masks["validity"][i] and masks["synthesizable"][i]]
        assert (tmp_path / "rewards/syn_filter/opt_filter.txt").is_file()


# ------------------------------------------------------ trainer and labels


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


@pytest.mark.parametrize("grad_clip", [1e3, 0.05])
def test_trainer_step_matches_optax(strucs, grad_clip):
    H, L, lr = 16, 1, 1e-3
    labels = np.random.default_rng(0).normal(size=N_CORPUS)
    jgnn = JaxGNN("mp_e_form", hidden_dim=H, num_layers=L, seed=1)
    gnn = PropertyGNN("mp_e_form", model_dir="", hidden_dim=H, num_layers=L, device="cpu")
    sd = params_from_jax(jax.tree.map(np.asarray, jgnn.params), prefix="")
    gnn.net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    corpus = strucs[:N_CORPUS]
    batch, y = next(labeled_batches(corpus, labels, 24, 32, np.random.default_rng(7)))
    jbatch, jy = next(jax_batches(to_jax(corpus), labels, 24, 32, np.random.default_rng(7)))
    np.testing.assert_array_equal(batch.atom_types.numpy(), np.asarray(jbatch.atom_types))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))

    jt = JaxTrainer(jgnn, lr=lr, grad_clip=grad_clip)
    j_params, j_state, j_loss = jt.step(jgnn.params, jt.optimizer.init(jgnn.params), jbatch, jy)
    trainer = PredictorTrainer(gnn, lr=lr, grad_clip=grad_clip)
    opt = trainer.optimizer()
    loss = trainer.step(opt, batch, y)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    # the clipped gradients (Adam's first moment after one step / (1 - b1))
    g_ref = params_from_jax(jax.tree.map(lambda m: np.asarray(m) / 0.1, _adam_state(j_state).mu),
                            prefix="")
    norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in g_ref.values()))
    assert (norm > grad_clip * 0.999) == (grad_clip < 1.0)
    for k, p in gnn.net.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(g_ref[k])
        scale = max(np.abs(g_ref[k]).max(), 1e-12)
        np.testing.assert_allclose(g, g_ref[k], atol=2e-5 * scale, err_msg=k)
    # the Adam update: lr * g / (|g| + eps) after one step, so a gradient
    # within its rounding of 0 may move by up to lr
    p_ref = params_from_jax(jax.tree.map(np.asarray, j_params), prefix="")
    for k, p in gnn.net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), p_ref[k], atol=1e-6 + lr * 1e-3, err_msg=k)


def test_port_trained_checkpoint_loads_in_jax(strucs, tmp_path):
    data = tmp_path / "data.extxyz"
    from matinvent_tpu_torch.chem.structure import save_extxyz

    save_extxyz(strucs[:40], str(data))
    rec = train_predictor.main(["--data", str(data), "--proxy", "--model-name", "mp_bulk_modulus",
                                "--output-dir", str(tmp_path / "out"), "--steps", "3",
                                "--batch-size", "8", "--hidden-dim", "16", "--num-layers", "1",
                                "--device", "cpu"])
    assert all(math.isfinite(v) for v in rec["losses"])
    jgnn = JaxGNN("mp_bulk_modulus", model_dir=str(tmp_path / "out"), hidden_dim=16, num_layers=1)
    gnn = PropertyGNN("mp_bulk_modulus", model_dir=tmp_path / "out", hidden_dim=16, num_layers=1,
                      device="cpu")
    assert jgnn.loaded and gnn.loaded
    assert (jgnn.y_mean, jgnn.y_std) == (gnn.y_mean, gnn.y_std) == (rec["y_mean"], rec["y_std"])
    close_with_nans(gnn.predict(strucs), jgnn.predict(to_jax(strucs)), atol=STD_TOL * gnn.y_std)
    meta = (tmp_path / "out/mp_bulk_modulus.meta.txt").read_text()
    assert "labels=proxy:mp_bulk_modulus" in meta


def test_proxy_labels_equal_jax_exactly(strucs):
    ok = [s for s, m in zip(strucs, syn_ok(strucs)) if m]
    assert LABEL_FNS.keys() == JAX_LABEL_FNS.keys()
    for name in LABEL_FNS:
        np.testing.assert_array_equal(label_structures(ok, name),
                                      jax_label_structures(to_jax(ok), name), err_msg=name)


# ------------------------------------------------ recipes and entry point


def _strip(node, calculator=False):
    """A config tree without Hydra ``_target_`` keys, a calculator's class
    (the last component of its ``_target_``) under ``class`` unless it is
    Empirical, repository paths taken from ``experiments/`` on."""
    if isinstance(node, dict):
        out = {k: _strip(v, k == "calculator") for k, v in node.items() if k != "_target_"}
        cls = node.get("_target_", "").rsplit(".", 1)[-1]
        if calculator and cls != "Empirical":
            out = {"class": cls, **out}
        return out
    if isinstance(node, list):
        return [_strip(v) for v in node]
    if isinstance(node, str) and "/experiments/" in node:
        return "experiments/" + node.split("/experiments/", 1)[1]
    return node


NEW_REWARDS = ["band_gap", "bulk_modulus", "dielectric", "figure_of_merit", "fom_gap_dielectric",
               "formation_energy", "gap_bulk", "mag_den_hhi", "magnetic_density", "pugh_ratio",
               "shear_modulus", "syn_score", "vickers_hardness", "young_modulus",
               "band_gap_alignn", "dft"]


@pytest.mark.parametrize("name", NEW_REWARDS)
def test_new_reward_sections_equal_the_configs(name):
    cfg = yaml.safe_load((ROOT / f"configs/reward/{name}.yaml").read_text())
    assert REWARDS[name] == _strip(cfg)


def test_mag_recipe_matches_the_archived_hparams():
    hp = _strip(yaml.safe_load(
        (ROOT / "experiments/results/rl_mag_rich_dense/hparams.yaml").read_text()))
    hp.pop("results_dir")
    assert RECIPES["rl_mag_rich_dense"] == hp
    cfg = mat_invent.resolve("rl_mag_rich_dense", rl_epoch=2)
    assert Path(cfg["model"]["model_path"]).name == "pretrained_geneval_r4"
    assert Path(cfg["model"]["sample_cfg"]["num_atoms_distribution_file"]).is_file()
    # the start checkpoint's config lacks five keys of r5's, which default
    r4 = read_flat_yaml(ROOT / "experiments/results/pretrained_geneval_r4/config.yaml")
    r5 = read_flat_yaml(
        ROOT / "experiments/results/pretrained_geneval_r5_r5_long_s120000_ema/config.yaml")
    assert set(r5) - set(r4) == {"cutoff", "edge_style", "fused_edge_sampling", "max_neighbors",
                                 "type_temperature"}


def test_r4_start_checkpoint_matches_jax_f32_net():
    path = "experiments/results/pretrained_geneval_r4"
    model = load_model(ROOT / path, device="cpu")
    jd, params = JaxSuite(model_path=str(ROOT / path)).load_model()
    c = model.config
    assert (c.hidden_dim, c.num_layers, c.time_dim) == (256, 6, 128)
    assert (c.edge_style, c.type_temperature) == ("fc", 1.0)
    rng = np.random.default_rng(9)
    B, A = 3, 10
    na = np.array([A, 4, 7], np.int32)
    x = dict(t=np.full((B,), 0.5, np.float32),
             time_emb=rng.normal(size=(B, c.time_dim)).astype(np.float32),
             types=rng.integers(0, 100, (B, A)).astype(np.int32),
             frac=rng.uniform(size=(B, A, 3)).astype(np.float32),
             lattice=(np.eye(3)[None] * 4.0 + rng.normal(size=(B, 3, 3)) * 0.3).astype(np.float32))
    fields = ("t", "time_emb", "types", "frac", "lattice")
    mask = np.arange(A)[None, :] < na[:, None]
    ref = jax.jit(lambda p: jd.apply_net(p, JaxNoised(*(jnp.asarray(x[k]) for k in fields)),
                                         jnp.asarray(na), jnp.asarray(mask)))(params)
    with torch.no_grad():
        out = model.apply_net(MGNoised(*(torch.from_numpy(x[k]) for k in fields)),
                              torch.from_numpy(na), torch.from_numpy(mask))
    for k in ref:
        r, o = np.asarray(ref[k]), out[k].numpy()
        if r.shape[:2] == mask.shape:
            r, o = r[mask], o[mask]
        np.testing.assert_allclose(o, r, atol=2e-4, rtol=0, err_msg=k)


TINY = [
    "--set", "model.model_path=null", "--set", "model.model_cfg.hidden_dim=32",
    "--set", "model.model_cfg.num_layers=2", "--set", "model.model_cfg.time_dim=16",
    "--set", "model.model_cfg.timesteps=10", "--set", "model.model_cfg.sample_clip=15.0",
    "--set", "model.finetune_cfg.timesteps=10", "--set", "pipeline.finetune_cfg.accum_steps=5",
    "--set", "pipeline.finetune_cfg.epochs=1", "--set", "model.sample_cfg.batch_size=6",
    # an untrained model gives almost no valid samples: the filter is off
    "--set", "pipeline.sample_cfg.invalid_filter=false",
]


@pytest.mark.parametrize("reward", ["magnetic_density", "gap_bulk"])
def test_entry_point_runs_a_predictor_reward_on_the_cpu(tmp_path, reward):
    out = tmp_path / "run"
    pipe = mat_invent.main(["--recipe", "rl_mag_rich_dense", "--rl-epoch", "1", "--reward", reward,
                            "--out", str(out), "--device", "cpu", *TINY])
    with open(out / "metrics.csv") as fh:
        row = next(csv.DictReader(fh))
    section = REWARDS[reward]
    strucs = read_extxyz(str(out / "samples/step_0000_eval.extxyz"))
    for i, p in enumerate(section["prop_cfg"]):
        assert f"{p['name']} mean" in row
        calc = pipe.reward.prop_cfg[i]["calculator"]
        assert isinstance(calc, PropertyPredictor) and calc.device.type == "cpu"
        saved = np.loadtxt(out / p["calculator"]["root_dir"] / "step_0000.txt")
        assert saved.shape == (len(strucs),)
        # the pipeline's calculator against JAX's on the saved samples (an
        # untrained sampler's cells may be degenerate: NaN and inf included)
        task = p["calculator"]["task"]
        ours = calc.calc((strucs, None), "again")
        ref = JaxPredictor(str(tmp_path / "jax"), task=task).calc((to_jax(strucs), None))
        close_with_nans(ours, ref, atol=task_tol(ref), rtol=DERIVED_RTOL, what=task)
    assert 0.0 <= float(row["reward mean"]) <= 1.0 and len(pipe.replay) > 0


def test_entry_point_builds_the_synthesizable_screen(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = mat_invent.resolve("rl_mag_rich_dense", 1, [a for a in TINY if a != "--set"] + [
        'pipeline.sample_cfg.filter={"metrics": ["validity", "synthesizable"]}'])
    pipe = mat_invent.build(cfg, str(tmp_path / "run"), device="cpu")
    assert isinstance(pipe.filter.syn_calculator, SynScore) and pipe.filter.syn_calculator.trained
    assert pipe.filter.syn_calculator.device.type == "cpu"
    # its scores go under the run's directory, not the working directory
    assert Path(pipe.filter.syn_calculator.root_dir) == tmp_path / "run" / "rewards" / "syn_filter"
    assert not (tmp_path / "rewards").exists()


# ---------------------------------------------------- the card's fixture


def test_committed_jax_values_are_current(strucs, tmp_path):
    fx = json.loads(FIXTURE.read_text())
    assert fx["n_corpus"] == N_CORPUS
    for rec, want in zip(fx["degenerate"], degenerate(strucs[0]), strict=True):
        assert rec.keys() == want.keys()
        for k in rec:
            np.testing.assert_array_equal(np.asarray(rec[k], float), want[k])
    # a slice, JAX recomputed: 8 corpus structures and the degenerate ones
    idx = list(range(8)) + list(range(N_CORPUS, len(strucs)))
    ref = jax_reference([strucs[i] for i in idx], tmp_path)
    assert ref["y_std"] == fx["y_std"]
    for name in MODELS:
        close_with_nans(np.asarray(fx["raw"][name])[idx], ref["raw"][name],
                        atol=STD_TOL * fx["y_std"][name], what=name)
    for task in TASKS:
        close_with_nans(np.asarray(fx["tasks"][task])[idx], ref["tasks"][task],
                        atol=task_tol(ref["tasks"][task]), rtol=DERIVED_RTOL, what=task)
    close_with_nans(np.asarray(fx["syn_score"])[idx], ref["syn_score"], atol=1e-6)
    # and the port on the CPU holds to it as chip_smoke.py holds the card
    port = PropertyPredictor(str(tmp_path / "port"), device="cpu")
    for name in MODELS:
        task = next(t for t, m in TASK_MODEL_DICT.items() if m == name)
        close_with_nans(port._model(task).predict([strucs[i] for i in idx]),
                        np.asarray(fx["raw"][name])[idx], atol=STD_TOL * fx["y_std"][name])


def write_fixture() -> None:
    head = corpus_head(N_CORPUS)
    deg = degenerate(head[0])
    with tempfile.TemporaryDirectory() as tmp:
        ref = jax_reference(head + structures_of(deg), Path(tmp))
    fx = dict(
        source=("the JAX package's PropertyPredictor and SynScore on the CPU "
                "(tests/test_torch_port_rewards.py), in-repo weights"),
        corpus="experiments/data/corpus_r5.extxyz", n_corpus=N_CORPUS,
        degenerate=[{k: np.asarray(v).tolist() for k, v in r.items()} for r in deg],
        models={t: m for t, m in TASK_MODEL_DICT.items() if m}, **ref,
    )
    FIXTURE.write_text(json.dumps(fx) + "\n")
    print(f"wrote {FIXTURE.relative_to(ROOT)}")


if __name__ == "__main__":
    write_fixture()
