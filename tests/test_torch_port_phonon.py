"""The port's native phonon and elastic workflows
(``matinvent_tpu_torch/chem/phonon.py``) and the MLIP bridge against the
JAX package's, on the CPU.

``supercell``, ``choose_reps`` and the mass table exactly; the Γ-point
Hessian at fixed structures within 1e-4 of its largest entry and the
non-acoustic frequencies within 1e-4 relative; ``gamma_heat_capacity`` and
``soft_sphere_bulk_modulus`` within 1e-3 relative on
``tests/test_phonon.py``'s LiF / PbS and 8 ``corpus_r5`` structures.

The scale search of the equilibration picks a local minimum on a 75-point
grid and refines it by 12 golden-section comparisons; an f32 rounding
difference between the two libraries can flip a comparison. Each
structure's decisions are recomputed on both sides' energies: the values
are compared where the decisions agree, and every structure where they
differ is named in the assertion (none are hidden by a wider tolerance).
The corpus structures enter as given (an identity relaxer on both sides),
because the coordinate descent is unstable on most of them
(``tests/test_torch_port_relax.py``); LiF and PbS go through the whole
workflow, relaxation included.
"""
from __future__ import annotations

import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matinvent_tpu.chem import phonon as jphonon
from matinvent_tpu.chem.structure import Structure as JaxStructure
from matinvent_tpu_torch.chem import phonon as pphonon
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz, save_extxyz
from matinvent_tpu_torch.rewards.calculators.mlip import MLIPBridge

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
KB = 1.380649e-23
AMU_G = 1.66053906660e-24
# a supercell budget that keeps the Hessians small on the CPU
SUPERCELL_ATOMS = 32


def rocksalt(a: float, cat: int, an: int, cls=Structure):
    return cls.from_parameters([a] * 3, [90] * 3, [cat, an],
                               np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]))


def to_jax(s: Structure) -> JaxStructure:
    return JaxStructure(s.lattice, s.species, s.frac_coords)


def corpus_small(n: int = 8) -> list[Structure]:
    """The first ``n`` corpus structures of at most 6 atoms."""
    return [s for s in read_extxyz(str(ROOT / "experiments/data/corpus_r5.extxyz"), limit=200)
            if s.num_atoms <= 6][:n]


def identity(structures):
    return list(structures), [0.0] * len(structures)


def _jax_strain(s, scales):
    fn = jphonon._strain_energy_fn(s.num_atoms)
    return np.asarray(fn(jnp.asarray(s.frac_coords % 1.0, jnp.float32),
                         jnp.asarray(s.lattice, jnp.float32),
                         jnp.asarray(s.species, jnp.int32),
                         jnp.asarray(scales, jnp.float32)), np.float64)


def _port_strain(s, scales):
    return pphonon.strain_energies(s, scales, CPU)


def decisions(s, energies) -> tuple:
    """(grid index, golden-section decisions) of the scale search on one
    side's energies: the search of ``_equilibrate``, step by step."""
    scales = pphonon.SCALE_GRID
    e = energies(s, scales)
    interior = np.where((e[1:-1] < e[:-2]) & (e[1:-1] <= e[2:]) & np.isfinite(e[1:-1]))[0] + 1
    if interior.size == 0:
        return (None,)
    k = int(interior[np.argmin(np.abs(scales[interior] - 1.0))])
    lo, hi = scales[k - 1], scales[k + 1]
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    out = [k]
    for _ in range(pphonon.GOLDEN_STEPS):
        m1, m2 = hi - gr * (hi - lo), lo + gr * (hi - lo)
        e1, e2 = energies(s, np.array([m1, m2]))
        out.append(bool(e1 < e2))
        hi, lo = (m2, lo) if e1 < e2 else (hi, m1)
    return tuple(out)


def test_supercell_choose_reps_and_masses_are_exact():
    for s in [rocksalt(4.0, 3, 9), rocksalt(5.9, 82, 16)] + corpus_small():
        for args in ((8.0, 160), (6.0, 70), (8.0, 10), (8.0, 3)):
            reps = pphonon.choose_reps(s, *args)
            assert reps == jphonon.choose_reps(to_jax(s), *args)
        sc, ref = pphonon.supercell(s, reps), jphonon.supercell(to_jax(s), reps)
        np.testing.assert_array_equal(sc.frac_coords, ref.frac_coords)
        np.testing.assert_array_equal(sc.lattice, ref.lattice)
        np.testing.assert_array_equal(sc.species, ref.species)
    np.testing.assert_array_equal(pphonon.MASSES_AMU, jphonon._MASSES_AMU)


def test_hessian_and_frequencies_match_jax():
    structs = [pphonon.supercell(rocksalt(3.8, 11, 17), (2, 2, 2)),
               pphonon.supercell(rocksalt(5.9, 82, 16), (2, 1, 1))] + corpus_small(3)
    for s in structs:
        h = pphonon.pair_hessian(s, CPU).numpy()
        ref = np.asarray(jphonon._hessian_fn(s.num_atoms)(
            jnp.asarray(s.frac_coords % 1.0, jnp.float32), jnp.asarray(s.lattice, jnp.float32),
            jnp.asarray(s.species, jnp.int32)))
        np.testing.assert_allclose(h, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
        w = np.sort(np.abs(pphonon.gamma_frequencies(s, device="cpu")))
        w_ref = np.sort(np.abs(jphonon.gamma_frequencies(to_jax(s))))
        # the 3 acoustic translations are near zero: compare the rest
        np.testing.assert_allclose(w[3:], w_ref[3:], rtol=1e-4, atol=0)


def _modes_above_floor(s, jax_side: bool) -> tuple[int, float]:
    """(modes above ``harmonic_heat_capacity``'s 1e10 rad/s floor, mass in
    grams) of the equilibrated supercell. The three acoustic translations
    are zero up to f32 rounding of the Hessian, which puts them near the
    floor: either library may count one of them."""
    if jax_side:
        eq = jphonon._equilibrate([to_jax(s)], identity)[0]
        sc = jphonon.supercell(eq, jphonon.choose_reps(eq, 8.0, SUPERCELL_ATOMS))
        w = jphonon.gamma_frequencies(sc)
    else:
        eq = pphonon.equilibrate([s], relaxer=identity, device="cpu")[0]
        sc = pphonon.supercell(eq, pphonon.choose_reps(eq, 8.0, SUPERCELL_ATOMS))
        w = pphonon.gamma_frequencies(sc, device="cpu")
    return int(np.sum(np.abs(w) > 1e10)), float(np.sum(pphonon.MASSES_AMU[sc.species])) * AMU_G


def test_heat_capacity_and_bulk_modulus_match_jax():
    """C_v within 1e-3 on every structure once the modes each side counted
    above the floor are accounted for (a mode of ω ≈ 1e10 rad/s adds k_B
    per mass to within 1e-7); the bulk modulus within 1e-3 wherever both
    sides' scale searches decide alike. The structures of either kind of
    flip are named in the report."""
    lif, pbs = rocksalt(4.0, 3, 9), rocksalt(5.9, 82, 16)
    # LiF and PbS through the whole workflow, relaxation included
    cv = pphonon.gamma_heat_capacity([lif, pbs], max_atoms=70, min_length=6.0, device="cpu")
    cv_ref = jphonon.gamma_heat_capacity([to_jax(lif), to_jax(pbs)], max_atoms=70, min_length=6.0)
    assert np.all(np.isfinite(cv)) and cv[0] > cv[1] > 0
    np.testing.assert_allclose(cv, cv_ref, rtol=1e-3, atol=0)

    # the scale search and what follows it, on the same structures
    structs = [lif, pbs] + corpus_small()
    for s in structs:
        k, _ = pphonon.scale_search(s, CPU)
        assert k == decisions(s, _port_strain)[0]
    search = [decisions(s, _port_strain) == decisions(s, _jax_strain) for s in structs]
    cv = pphonon.gamma_heat_capacity(structs, relaxer=identity, max_atoms=SUPERCELL_ATOMS,
                                     device="cpu")
    cv_ref = jphonon.gamma_heat_capacity([to_jax(s) for s in structs], relaxer=identity,
                                         max_atoms=SUPERCELL_ATOMS)
    bm = pphonon.soft_sphere_bulk_modulus(structs, relaxer=identity, device="cpu")
    bm_ref = jphonon.soft_sphere_bulk_modulus([to_jax(s) for s in structs], relaxer=identity)
    floor_modes = []
    for i, s in enumerate(structs):
        (n, mass_g), (n_ref, _) = _modes_above_floor(s, False), _modes_above_floor(s, True)
        if n != n_ref:
            floor_modes.append(s.composition.formula)
        expected = cv_ref[i] + (n - n_ref) * KB / mass_g
        np.testing.assert_allclose(cv[i], expected, rtol=1e-3, atol=0, err_msg=str(i))
    flips = [s.composition.formula for s, same in zip(structs, search) if not same]
    print(f"modes counted differently: {floor_modes}; scale searches that differ: {flips}")
    same = [i for i, f in enumerate(search) if f]
    assert len(same) >= 8, flips
    np.testing.assert_allclose(bm[same], bm_ref[same], rtol=1e-3, atol=0, err_msg=str(flips))


@pytest.mark.parametrize("task", ["heat_capacity", "bulk_modulus"])
def test_mlip_bridge_round_trip(tmp_path, task):
    """The worker subprocess on the CPU writes what the native workflow
    gives on the structures it reads back (to the 6 decimals of its file),
    and names the native backend on stderr."""
    # small supercells after equilibration (8 and 54 atoms): quick on the CPU
    cs = Structure.from_parameters([5.0] * 3, [90] * 3, [55], np.zeros((1, 3)))
    structs = [cs, rocksalt(5.0, 55, 53)]
    bridge = MLIPBridge(root_dir=str(tmp_path / task), task=task, device="cpu")
    out = bridge.calc((structs, None), label="step_0000")
    back = read_extxyz(str(tmp_path / task / "step_0000.extxyz"))
    native = (pphonon.gamma_heat_capacity if task == "heat_capacity"
              else pphonon.soft_sphere_bulk_modulus)(back, device="cpu")
    np.testing.assert_allclose(out, np.round(native, 6), rtol=0, atol=1e-6)
    assert "backend: native soft-sphere" in bridge.last_stderr
    assert "on cpu" in bridge.last_stderr


def test_mlip_bridge_raises_when_the_worker_fails(tmp_path):
    """A worker that exits non-zero (here: an extxyz it cannot read) makes
    the bridge raise; nothing turns the batch into NaN."""
    bad = tmp_path / "bad.extxyz"
    good = save_extxyz([rocksalt(5.0, 55, 53)], str(tmp_path / "good.extxyz"))
    bad.write_text(Path(good).read_text().replace("Cs", "Xx"))
    bridge = MLIPBridge(root_dir=str(tmp_path / "hc"), task="heat_capacity", device="cpu")
    with pytest.raises(RuntimeError, match="MLIP worker failed"):
        bridge.calc(([rocksalt(5.0, 55, 53)], str(bad)), label="x")
    with pytest.raises(ValueError, match="unknown task"):
        MLIPBridge(root_dir=str(tmp_path / "y"), task="band_gap", device="cpu")
    # the worker script alone, asked for the card where there is none
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [__import__("sys").executable, bridge.TASK_SCRIPTS["heat_capacity"], good,
             str(tmp_path / "o.txt"), "1"], capture_output=True, text=True)
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
        assert not (tmp_path / "o.txt").exists()


# a stand-in MLIP stack for the worker's quacc branch: ``ase.Atoms`` and
# quacc's three recipes, failing on a one-atom structure ("one"), on every
# structure ("all"), or missing (``quacc.recipes`` absent: "import")
_FAKE_ASE = """
class Atoms:
    def __init__(self, numbers, scaled_positions, cell, pbc):
        self.numbers = list(numbers)
"""
_FAKE_RECIPES = {
    "core.py": """
import os
def relax_job(atoms, relax_cell, **params):
    if os.environ["FAKE_QUACC"] == "all" or len(atoms.numbers) == 1:
        raise RuntimeError("no weights")
    return {"atoms": atoms}
""",
    "phonons.py": """
def phonon_flow(atoms, job_params, t_min, t_max, t_step):
    tp = {"temperatures": [299.0, 300.0], "heat_capacity": [0.0, 1.5]}
    return {"results": {"thermal_properties": tp}}
""",
    "elastic.py": """
import os
from types import SimpleNamespace
def elastic_tensor_flow(atoms, job_params):
    if os.environ["FAKE_QUACC"] == "all" or len(atoms.numbers) == 1:
        raise RuntimeError("no weights")
    return {"elasticity_doc": SimpleNamespace(bulk_modulus=SimpleNamespace(voigt=42.0))}
""",
}


@pytest.mark.parametrize("case", ["one", "all", "import"])
@pytest.mark.parametrize("task", ["heat_capacity", "bulk_modulus"])
def test_mlip_bridge_quacc_branch_fails_loudly(tmp_path, monkeypatch, task, case):
    """The worker's quacc branch, on a stand-in quacc: NaN only for the
    structure its workflow fails on; a workflow that fails on every
    structure, or recipes that cannot be imported, end the worker non-zero
    and the bridge raises."""
    site = tmp_path / "site"
    (site / "ase").mkdir(parents=True)
    (site / "ase" / "__init__.py").write_text(_FAKE_ASE)
    (site / "quacc").mkdir()
    (site / "quacc" / "__init__.py").write_text("")
    if case != "import":
        mlp = site / "quacc" / "recipes" / "mlp"
        mlp.mkdir(parents=True)
        (site / "quacc" / "recipes" / "__init__.py").write_text("")
        (mlp / "__init__.py").write_text("")
        for name, text in _FAKE_RECIPES.items():
            (mlp / name).write_text(text)
    monkeypatch.setenv("PYTHONPATH", str(site))
    monkeypatch.setenv("FAKE_QUACC", case)
    cs = Structure.from_parameters([5.0] * 3, [90] * 3, [55], np.zeros((1, 3)))
    bridge = MLIPBridge(root_dir=str(tmp_path / task), task=task, device="cpu")
    if case == "one":
        out = bridge.calc(([cs, rocksalt(5.0, 55, 53)], None), label="q")
        assert np.isnan(out[0]) and out[1] == (1.5 if task == "heat_capacity" else 42.0)
        assert "NaN for 1 of 2 structures" in bridge.last_stderr
    else:
        with pytest.raises(RuntimeError, match="MLIP worker failed") as err:
            bridge.calc(([cs, rocksalt(5.0, 55, 53)], None), label="q")
        assert ("ModuleNotFoundError" if case == "import" else "every structure") in str(err.value)
    assert "backend: quacc MLIP" in bridge.last_stderr


def test_degenerate_cells_give_nan_as_in_jax():
    """A zero-volume cell (an untrained sampler's output) gets NaN in both
    packages, per structure, beside a finite neighbour."""
    flat = Structure(np.array([[-30.0, -30, 30], [-30, -30, 30], [30, 30, -30]]),
                     [82, 8], np.array([[0.1, 0.2, 0.3], [0.5, 0.5, 0.5]]))
    cs = Structure.from_parameters([5.0] * 3, [90] * 3, [55], np.zeros((1, 3)))
    for fn, jfn in ((pphonon.gamma_heat_capacity, jphonon.gamma_heat_capacity),
                    (pphonon.soft_sphere_bulk_modulus, jphonon.soft_sphere_bulk_modulus)):
        ours = fn([flat, cs], device="cpu")
        ref = jfn([to_jax(flat), to_jax(cs)])
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
        assert np.isnan(ours[0]) and np.isfinite(ours[1])


def test_rl_heat_capacity_recipe_is_the_archived_jax_run():
    from test_torch_port_ddpo import _holds_yaml

    cfg = _holds_yaml("rl_heat_capacity_t1000")
    assert "finetune_mode" not in cfg["pipeline"]
    assert cfg["reward"]["prop_cfg"][0]["calculator"]["class"] == "MLIPBridge"
