"""The port's ALIGNN calculator against the JAX package's, on the CPU.

Graphs: the port's builder against JAX's, integer for integer (edges,
images, line graph) and bit for bit (bond lengths, cosines), on the JAX
suite's cases (ties at the 12th neighbour, the widening cutoff) and on
corpus structures. The forward: random state dicts built as
``tests/test_alignn_native.py`` builds them (h16, 2 ALIGNN and 2 GCN
layers), through JAX's ``run_batch`` (f32, ``Precision.HIGHEST``) and the
port's (f32, TF32 off), within 1e-5 of the output's scale. The loaders read
the same files to the same parameters, spec and atom table in both
packages; ``ALIGNN``'s direct and derived tasks equal JAX's within 1e-5.
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from matinvent_tpu.chem.structure import Structure as JaxStructure
from matinvent_tpu.rewards.calculators.alignn import ALIGNN as JaxALIGNN
from matinvent_tpu.rewards.calculators.alignn import graphs as jgraphs
from matinvent_tpu.rewards.calculators.alignn.load import load_alignn_checkpoint as jax_load
from matinvent_tpu.rewards.calculators.alignn.model import ALIGNNSpec as JaxSpec
from matinvent_tpu.rewards.calculators.alignn.model import run_batch as jax_run_batch
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz
from matinvent_tpu_torch.rewards.calculators.alignn import ALIGNN, ALIGNNSpec, run_batch
from matinvent_tpu_torch.rewards.calculators.alignn import graphs
from matinvent_tpu_torch.rewards.calculators.alignn.load import load_alignn_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "experiments", "data", "corpus_r5.extxyz")
HID, EMB, ABINS, EBINS, AFEAT = 16, 8, 10, 12, 92
FWD_TOL = 1e-5  # of the output's scale


def _make_state_dict(rng, norm="batchnorm", alignn_layers=2, gcn_layers=2, hidden=HID,
                     out_features=1):
    sd = {}

    def lin(name, nin, nout):
        sd[f"{name}.weight"] = rng.normal(0, 0.3, (nout, nin)).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, (nout,)).astype(np.float32)

    def nrm(name, n):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, (n,)).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, (n,)).astype(np.float32)
        if norm == "batchnorm":
            sd[f"{name}.running_mean"] = rng.normal(0, 0.2, (n,)).astype(np.float32)
            sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, (n,)).astype(np.float32)
            sd[f"{name}.num_batches_tracked"] = np.array(10, dtype=np.int64)

    def mlp(name, nin, nout):
        lin(f"{name}.layer.0", nin, nout)
        nrm(f"{name}.layer.1", nout)

    mlp("atom_embedding", AFEAT, hidden)
    sd["edge_embedding.0.centers"] = np.linspace(0, 8, EBINS).astype(np.float32)
    mlp("edge_embedding.1", EBINS, EMB)
    mlp("edge_embedding.2", EMB, hidden)
    sd["angle_embedding.0.centers"] = np.linspace(-1, 1, ABINS).astype(np.float32)
    mlp("angle_embedding.1", ABINS, EMB)
    mlp("angle_embedding.2", EMB, hidden)

    def egc(prefix):
        for part in ("src_gate", "dst_gate", "edge_gate", "src_update", "dst_update"):
            lin(f"{prefix}.{part}", hidden, hidden)
        nrm(f"{prefix}.bn_edges", hidden)
        nrm(f"{prefix}.bn_nodes", hidden)

    for i in range(alignn_layers):
        egc(f"alignn_layers.{i}.node_update")
        egc(f"alignn_layers.{i}.edge_update")
    for i in range(gcn_layers):
        egc(f"gcn_layers.{i}")
    lin("fc", hidden, out_features)
    return sd


def _model_config(link="identity", classification=False, out_features=1):
    return {
        "alignn_layers": 2, "gcn_layers": 2, "atom_input_features": AFEAT,
        "edge_input_features": EBINS, "triplet_input_features": ABINS,
        "embedding_features": EMB, "hidden_features": HID,
        "output_features": out_features, "link": link, "classification": classification,
    }


def _atom_init(path, rng):
    table = {str(z): rng.normal(0, 1, (AFEAT,)).round(4).tolist() for z in range(1, 90)}
    with open(path, "w") as fh:
        json.dump(table, fh)
    return path


def _pair(lattice, species, frac):
    return (Structure(lattice, species, frac), JaxStructure(lattice, species, frac))


def _cases():
    """(port, JAX) structure pairs: the JAX suite's rocksalt, triclinic,
    simple cubic (ties) and sparse cell (widening), and six corpus
    structures."""
    rng = np.random.default_rng(3)
    rock = Structure.from_parameters([4.2] * 3, [90] * 3, [11, 17], [[0, 0, 0], [0.5, 0.5, 0.5]])
    out = [
        _pair(rock.lattice, rock.species, rock.frac_coords),
        _pair(np.array([[5.1, 0, 0], [1.1, 4.8, 0], [0.4, 0.3, 5.5]]), [3, 8, 8, 22],
              rng.uniform(0, 1, (4, 3))),
        _pair(np.eye(3) * 3.0, [29], np.zeros((1, 3))),
        _pair(np.eye(3) * 12.0, [6], np.zeros((1, 3))),
    ]
    for s in read_extxyz(CORPUS, limit=6):
        out.append(_pair(s.lattice, s.species, s.frac_coords))
    return out


CASES = _cases()


# ---------------------------------------------------------------- graphs

@pytest.mark.parametrize("i", range(len(CASES)))
def test_graph_equals_jax_integer_for_integer(i):
    s, js = CASES[i]
    src, dst, vec = graphs.knn_edges(s)
    jsrc, jdst, jvec = jgraphs.knn_edges(js)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    np.testing.assert_array_equal(vec, jvec)
    a, b = graphs.line_graph_pairs(src, dst)
    ja, jb = jgraphs.line_graph_pairs(jsrc, jdst)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(graphs.bond_cosines(vec, a, b), jgraphs.bond_cosines(jvec, ja, jb))


def test_ties_widening_and_line_graph_counts():
    # simple cubic: shells of 6 and 12 tie at the 12th neighbour: 18 images,
    # each in both directions
    src, dst, vec = graphs.knn_edges(CASES[2][0])
    assert len(src) == 36 and (src == 0).all()
    # one atom in a 12 A cell sees nobody within 8 A: the cutoff widens
    assert len(graphs.knn_edges(CASES[3][0])[0]) >= 12
    s = CASES[0][0]
    src, dst, _ = graphs.knn_edges(s)
    a, b = graphs.line_graph_pairs(src, dst)
    assert (dst[a] == src[b]).all()
    indeg = np.bincount(dst, minlength=s.num_atoms)
    assert all(int((b == e).sum()) == int(indeg[src[e]]) for e in range(len(src)))


def test_build_batch_equals_jax():
    ours = graphs.build_batch([p for p, _ in CASES], pad_multiple=64)
    ref = jgraphs.build_batch([j for _, j in CASES], pad_multiple=64)
    assert ours.num_graphs == ref.num_graphs and ours.padded_sizes == ref.padded_sizes
    for k in ("species", "node_graph", "node_mask", "edge_src", "edge_dst", "edge_len",
              "edge_mask", "trip_a", "trip_b", "trip_cos", "trip_mask"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k), err_msg=k)


# --------------------------------------------------------------- forward

def _forward_pair(sd, cfg, norm, structures, table, pad=64):
    spec = ALIGNNSpec.from_model_config(cfg, norm)
    params = {k: torch.as_tensor(v) for k, v in sd.items()}
    got = run_batch(params, spec, torch.as_tensor(table),
                    graphs.build_batch([p for p, _ in structures], pad_multiple=pad))
    want = jax_run_batch(sd, JaxSpec.from_model_config(cfg, norm), table,
                         jgraphs.build_batch([j for _, j in structures], pad_multiple=pad))
    return got, np.asarray(want, float)


@pytest.mark.parametrize("norm,link,classification", [
    ("batchnorm", "identity", False), ("layernorm", "identity", False),
    ("batchnorm", "log", False), ("layernorm", "logit", False), ("batchnorm", "identity", True),
])
def test_forward_matches_jax(norm, link, classification):
    rng = np.random.default_rng(0)
    out = 2 if classification else 1
    sd = _make_state_dict(rng, norm=norm, out_features=out)
    table = rng.normal(0, 1, (101, AFEAT)).astype(np.float32)
    got, want = _forward_pair(sd, _model_config(link, classification, out), norm, CASES, table)
    assert got.shape == want.shape == ((len(CASES), 2) if classification else (len(CASES),))
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= FWD_TOL * scale
    if link == "log":
        assert (got > 0).all()
    if link == "logit":
        assert ((got > 0) & (got < 1)).all()
    if classification:
        np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)


def test_permutation_invariance_and_batch_equals_singles():
    rng = np.random.default_rng(1)
    sd = _make_state_dict(rng)
    spec = ALIGNNSpec.from_model_config(_model_config(), "batchnorm")
    params = {k: torch.as_tensor(v) for k, v in sd.items()}
    table = torch.as_tensor(rng.normal(0, 1, (101, AFEAT)).astype(np.float32))
    s = CASES[1][0]
    perm = np.array([2, 0, 3, 1])
    sp = Structure(s.lattice, s.species[perm], s.frac_coords[perm])
    a = run_batch(params, spec, table, graphs.build_batch([s], pad_multiple=64))
    b = run_batch(params, spec, table, graphs.build_batch([sp], pad_multiple=64))
    np.testing.assert_allclose(a, b, rtol=1e-5)
    structures = [p for p, _ in CASES[:4]]
    both = run_batch(params, spec, table, graphs.build_batch(structures, pad_multiple=64))
    singles = [run_batch(params, spec, table, graphs.build_batch([x], pad_multiple=64))[0]
               for x in structures]
    np.testing.assert_allclose(both, singles, rtol=1e-5)


# --------------------------------------------------------------- loaders

def _write_hf(root, sd, cfg, rng, prop="band_gap"):
    d = os.path.join(root, "prop_pred", "alignn", prop)
    os.makedirs(d, exist_ok=True)
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
               os.path.join(d, "best_model.pt"))
    with open(os.path.join(d, "config.json"), "w") as fh:
        json.dump({"model": cfg}, fh)
    return d


def _same_load(ours, ref):
    params, spec, table = ours
    jparams, jspec, jtable = ref
    assert spec.__dict__ == jspec.__dict__
    assert set(params) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))


def test_hf_folder_and_figshare_zip_load_as_jax(tmp_path):
    rng = np.random.default_rng(4)
    d = _write_hf(str(tmp_path / "hf"), _make_state_dict(rng), _model_config(), rng)
    _atom_init(os.path.join(d, "atom_init.json"), rng)
    _same_load(load_alignn_checkpoint(d), jax_load(d))

    sd = _make_state_dict(rng, norm="layernorm")
    pt = tmp_path / "tmp.pt"
    torch.save({"model": {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}}, str(pt))
    zpath = tmp_path / "mp_gappbe_alignn.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.writestr("mp_gappbe_alignn/config.json", json.dumps({"model": _model_config("log")}))
        z.write(str(pt), "mp_gappbe_alignn/best_model.pt")
    _atom_init(str(tmp_path / "atom_init.json"), rng)
    ours = load_alignn_checkpoint(str(zpath))
    assert ours[1].link == "log" and ours[1].norm_kind == "layernorm"
    _same_load(ours, jax_load(str(zpath)))


def test_refused_option_and_missing_atom_table_are_loud(tmp_path):
    rng = np.random.default_rng(7)
    cfg = dict(_model_config(), use_cutoff_function=True)
    d = _write_hf(str(tmp_path / "a"), _make_state_dict(rng), cfg, rng)
    _atom_init(os.path.join(d, "atom_init.json"), rng)
    with pytest.raises(ValueError, match="use_cutoff_function"):
        load_alignn_checkpoint(d)
    d = _write_hf(str(tmp_path / "b"), _make_state_dict(rng), _model_config(), rng)
    with pytest.raises(FileNotFoundError, match="atom_init"):
        load_alignn_checkpoint(d)
    # the width of the state dict is checked against the spec
    d = _write_hf(str(tmp_path / "c"), _make_state_dict(rng, hidden=8), _model_config(), rng)
    _atom_init(os.path.join(d, "atom_init.json"), rng)
    with pytest.raises(ValueError, match="hidden"):
        load_alignn_checkpoint(d)


# ------------------------------------------------------------ calculator

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("alignn_models")
    rng = np.random.default_rng(8)
    for prop in ("band_gap", "bulk_modulus_voigt", "shear_modulus_voigt",
                 "total_magnetization_per_atom"):
        _write_hf(str(root), _make_state_dict(rng), _model_config(), rng, prop)
    _atom_init(str(root / "prop_pred" / "alignn" / "atom_init.json"), rng)
    return root


@pytest.mark.parametrize("task", ["band_gap", "vickers_hardness", "magnetic_density"])
def test_calculator_tasks_equal_jax(task, model_dir, tmp_path):
    pairs = CASES[:2] + CASES[4:]
    bad = _pair(np.eye(3) * np.nan, [6], np.zeros((1, 3)))  # screened: NaN in both
    ours = ALIGNN(str(tmp_path / "p"), task=task, model_dir=str(model_dir), device="cpu")
    ref = JaxALIGNN(str(tmp_path / "j"), task=task, model_dir=str(model_dir))
    got = ours.calc(([p for p, _ in pairs] + [bad[0]], None), label="t")
    want = ref.calc(([j for _, j in pairs] + [bad[1]], None), label="t")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[-1])
    ok = np.isfinite(want)
    scale = max(float(np.abs(want[ok]).max()), 1e-12)
    assert float(np.abs(got[ok] - want[ok]).max()) <= FWD_TOL * scale
    if task == "vickers_hardness":
        assert (tmp_path / "p" / "t_bulk.txt").exists()


def test_calculator_without_checkpoints_raises_at_scoring(tmp_path):
    calc = ALIGNN(str(tmp_path / "rew"), task="band_gap", model_dir=str(tmp_path / "empty"),
                  device="cpu")
    with pytest.raises(FileNotFoundError, match="band_gap"):
        calc.calc(([CASES[0][0]], None), label="t")
    with pytest.raises(ValueError, match="unknown task"):
        ALIGNN(str(tmp_path / "rew"), task="nonsense", device="cpu")
