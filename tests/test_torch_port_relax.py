"""The port's soft-sphere relaxer (``matinvent_tpu_torch/chem/relax.py``)
against the JAX package's, on the CPU.

The pair energy and its gradient within 1e-5 of their scale; descent on
``tests/test_relax.py``'s cases and 16 ``corpus_r5`` structures: coords
within 1e-4 (circular) and energies within 1e-4 relative; the
oversize passthrough, the ``xyz_path`` write-back, and the ``OptFilter``
relax-then-stability path of ``test_relaxer_with_optfilter_stability``.
On corpus structures whose descent is unstable in JAX too (it departs from
itself under a 1e-7 perturbation of the cell) the 50-step comparison is
not made; every structure is held at 2 steps.
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matinvent_tpu.chem import relax as jrelax
from matinvent_tpu.chem.structure import Structure as JaxStructure
from matinvent_tpu.models.batch import CrystalBatch as JaxBatch
from matinvent_tpu.pipeline import filters as jfilters
from matinvent_tpu_torch.chem import relax as prelax
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz
from matinvent_tpu_torch.pipeline import filters as pfilters

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "experiments/data/corpus_r5.extxyz"


def overlapping_pair(cls=Structure):
    # two C atoms far too close (0.6 A) in a roomy box
    return cls.from_parameters([6, 6, 6], [90, 90, 90], [6, 6], np.array([[0.0, 0, 0], [0.1, 0, 0]]))


def big(cls=Structure):
    return cls.from_parameters([6, 6, 6], [90, 90, 90], [6, 6, 6],
                               np.array([[0, 0, 0], [0.3, 0.3, 0.3], [0.6, 0.6, 0.6]]))


def cases() -> list[Structure]:
    """``tests/test_relax.py``'s structures and 16 of the corpus."""
    return [overlapping_pair(), big()] + read_extxyz(str(CORPUS), limit=16)


def to_jax(s: Structure) -> JaxStructure:
    return JaxStructure(s.lattice, s.species, s.frac_coords)


def random_batch(B=4, A=6, seed=0):
    rng = np.random.default_rng(seed)
    n = rng.integers(2, A + 1, B).astype(np.int32)
    types = rng.integers(1, 60, (B, A)).astype(np.int32) * (np.arange(A) < n[:, None])
    frac = rng.uniform(size=(B, A, 3)).astype(np.float32)
    lat = (np.eye(3)[None] * rng.uniform(3.0, 6.0, (B, 1, 1))
           + rng.normal(size=(B, 3, 3)) * 0.3).astype(np.float32)
    return types, frac, lat, n


def test_pair_energy_and_gradient_match_jax():
    types, frac, lat, n = random_batch()
    jb = JaxBatch(atom_types=jnp.asarray(types), frac_coords=jnp.asarray(frac),
                  lattice=jnp.asarray(lat), num_atoms=jnp.asarray(n))
    radii = jnp.asarray(jrelax._COVALENT_RADII)

    def jax_energy(f, l):
        return jnp.sum(jrelax._pair_energy(jb.replace(frac_coords=f, lattice=l), radii))

    e_ref = np.asarray(jrelax._pair_energy(jb, radii))
    g_ref = [np.asarray(g) for g in jax.grad(jax_energy, argnums=(0, 1))(jb.frac_coords, jb.lattice)]

    f = torch.from_numpy(frac).requires_grad_(True)
    l = torch.from_numpy(lat).requires_grad_(True)
    mask = torch.arange(frac.shape[1])[None, :] < torch.from_numpy(n)[:, None]
    prad = torch.as_tensor(prelax.COVALENT_RADII)
    e = prelax.pair_energy(f, l, torch.from_numpy(types), mask, prad)
    g = torch.autograd.grad(e.sum(), (f, l))
    np.testing.assert_allclose(e.detach().numpy(), e_ref, rtol=0,
                               atol=1e-5 * np.abs(e_ref).max())
    for ours, ref in zip(g, g_ref):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _circular(a: Structure, b) -> float:
    return float(np.abs((a.frac_coords - b.frac_coords + 0.5) % 1.0 - 0.5).max())


def _relax_both(structures, steps):
    ours, e = prelax.SoftSphereRelaxer(steps=steps, max_atoms=20, device="cpu")(structures)
    ref, e_ref = jrelax.SoftSphereRelaxer(steps=steps, max_atoms=20)([to_jax(s) for s in structures])
    return ours, np.asarray(e), ref, np.asarray(e_ref)


def _assert_tracks(ours, e, ref, e_ref, rows):
    for i in rows:
        np.testing.assert_array_equal(ours[i].species, ref[i].species)
        assert _circular(ours[i], ref[i]) < 1e-4, i
        np.testing.assert_allclose(ours[i].lattice, ref[i].lattice, rtol=0, atol=1e-4)
        np.testing.assert_allclose(e[i], e_ref[i], rtol=1e-4, atol=0, err_msg=str(i))


def test_relaxer_matches_jax_on_its_cases_and_the_corpus():
    """50 steps on ``tests/test_relax.py``'s cases and 16 corpus structures.

    On most corpus structures the descent (lr 2e-3 on coords and cell) is
    unstable in both packages: the energy rises and f32 rounding grows
    without bound. There the JAX package departs from itself under a 1e-7
    relative perturbation of the cell as far as the port departs from it.
    So the port is held within 1e-4 on every structure at 2 steps, and at
    50 steps on every structure whose JAX trajectory survives that
    perturbation (the two test cases and 3 of the 16)."""
    structures = cases()
    ours, e, ref, e_ref = _relax_both(structures, steps=2)
    _assert_tracks(ours, e, ref, e_ref, range(len(structures)))

    ours, e, ref, e_ref = _relax_both(structures, steps=50)
    assert np.all(np.isfinite(e))
    rng = np.random.default_rng(0)
    perturbed = [JaxStructure(s.lattice * (1 + 1e-7 * rng.standard_normal((3, 3))),
                              s.species, s.frac_coords) for s in structures]
    ref_p, _ = jrelax.SoftSphereRelaxer(steps=50, max_atoms=20)(perturbed)
    stable = [i for i in range(len(structures)) if _circular(ref_p[i], ref[i]) < 1e-4]
    assert stable == [0, 1, 7, 8, 16], stable
    _assert_tracks(ours, e, ref, e_ref, stable)
    # the overlapping pair separates, as tests/test_relax.py requires
    assert ours[0].min_interatomic_distance() > overlapping_pair().min_interatomic_distance()


def test_relaxer_oversize_passthrough_and_xyz_write_back(tmp_path):
    s = big()
    path = tmp_path / "valid.extxyz"
    relaxed, energies = prelax.SoftSphereRelaxer(steps=10, max_atoms=2, device="cpu")(
        [s, overlapping_pair()], str(path))
    ref, ref_e = jrelax.SoftSphereRelaxer(steps=10, max_atoms=2)(
        [big(JaxStructure), overlapping_pair(JaxStructure)])
    assert np.isnan(energies[0]) and np.isnan(ref_e[0])
    assert relaxed[0] is s
    np.testing.assert_allclose(energies[1], ref_e[1], rtol=1e-4)
    back = read_extxyz(str(path))
    assert len(back) == 2
    np.testing.assert_allclose(back[1].lattice, relaxed[1].lattice, atol=1e-6)
    assert relaxed[1].min_interatomic_distance() == pytest.approx(
        back[1].min_interatomic_distance(), abs=1e-5)
    assert prelax.SoftSphereRelaxer(device="cpu")([]) == ([], [])


def test_relaxer_with_optfilter_stability():
    """``OptFilter(relax=True, relaxer=...)`` relaxes, then screens the
    relaxer's energies on the hull, as JAX's
    ``test_relaxer_with_optfilter_stability``."""
    ref_flt = jfilters.OptFilter(
        metrics=["stable"], relax=True,
        relaxer=jrelax.SoftSphereRelaxer(steps=50, max_atoms=8),
        reference=jfilters.ReferenceDataset(phase_entries=[("C", 0.0)]), ehull_threshold=1000.0,
    )
    flt = pfilters.OptFilter(
        metrics=["stable"], relax=True,
        relaxer=prelax.SoftSphereRelaxer(steps=50, max_atoms=8, device="cpu"),
        reference=pfilters.ReferenceDataset(phase_entries=[("C", 0.0)]), ehull_threshold=1000.0,
        device="cpu",
    )
    data, strucs, metrics = flt(["a"], [overlapping_pair()])
    rdata, rstrucs, rmetrics = ref_flt(["a"], [overlapping_pair(JaxStructure)])
    assert "frac_stable" in metrics
    assert metrics == rmetrics and data == rdata
    d = (strucs[0].frac_coords - rstrucs[0].frac_coords + 0.5) % 1.0 - 0.5
    assert np.abs(d).max() < 1e-4
    # OptEval relaxes too
    ev, _ = pfilters.OptEval(relax=True, relaxer=flt.relaxer, metrics=["stable"],
                             reference=flt.reference, device="cpu")([overlapping_pair()])
    assert ev == metrics
