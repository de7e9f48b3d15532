"""Analytic proxy labels for self-training the reward predictors
(``matinvent_tpu/chem/proxy_labels.py``, copied onto the port's tables).

Smooth functions of composition and geometry, defined for every structure
(NaN only for a degenerate cell), clipped to plausible ranges: bulk and
shear modulus from the volume per atom and ionic character, band gap from
the electronegativity spread, formation energy, the per-atom magnetic
moment, and a Penn-like dielectric constant. The predictor weights of the
JAX package were trained on these labels of the proxy corpus.
"""
from __future__ import annotations

import numpy as np

from matinvent_tpu_torch.chem.data import ELECTRONEGATIVITY, METALS, SYMBOLS
from matinvent_tpu_torch.chem.structure import Structure

# bulk elemental moments (mu_B/atom), spin-only flavored; non-listed -> 0
MAGNETIC_MOMENTS = {
    "Cr": 1.6, "Mn": 2.7, "Fe": 2.2, "Co": 1.7, "Ni": 0.6,
    "Gd": 7.0, "Tb": 6.0, "Dy": 5.5, "Ho": 5.0, "Er": 4.0,
    "Nd": 3.0, "Sm": 1.5, "Eu": 7.0, "Tm": 3.0,
    "V": 0.9, "Ti": 0.3, "Ru": 0.4, "Rh": 0.3, "Pd": 0.2, "Pt": 0.1,
}

_CHI = np.zeros(101)
_MOM = np.zeros(101)
_IS_METAL = np.zeros(101, dtype=bool)
for _z, _s in enumerate(SYMBOLS):
    if _z == 0 or _z > 100:
        continue
    _CHI[_z] = ELECTRONEGATIVITY.get(_s, 1.6)
    _MOM[_z] = MAGNETIC_MOMENTS.get(_s, 0.0)
    _IS_METAL[_z] = _s in METALS


def _vpa(s: Structure) -> float:
    """Volume per atom in A^3, guarded."""
    v = float(s.volume)
    if not np.isfinite(v) or v <= 1e-6 or s.num_atoms == 0:
        return float("nan")
    return v / s.num_atoms


def _chi_spread(s: Structure) -> float:
    chi = _CHI[np.clip(s.species, 0, 100)]
    return float(chi.max() - chi.min())


def _metal_fraction(s: Structure) -> float:
    return float(_IS_METAL[np.clip(s.species, 0, 100)].mean())


def _crowding(s: Structure) -> float:
    """Fraction of atom pairs closer than 1.2 A (overlap penalty signal)."""
    if s.num_atoms < 2:
        return 0.0
    d = s.distance_matrix()
    iu = np.triu_indices(s.num_atoms, k=1)
    return float((d[iu] < 1.2).mean())


def bulk_modulus_gpa(s: Structure) -> float:
    """B ~ 5500/vpa^1.5, softened by ionic character. Range ~[2, 400] GPa."""
    vpa = _vpa(s)
    if not np.isfinite(vpa):
        return float("nan")
    b = 5500.0 / max(vpa, 4.0) ** 1.5
    b *= 1.0 - 0.12 * min(_chi_spread(s), 3.0)
    return float(np.clip(b, 2.0, 400.0))


def shear_modulus_gpa(s: Structure) -> float:
    """G ~ 0.6*B for covalent/ionic, lower for metals (ductility)."""
    b = bulk_modulus_gpa(s)
    if not np.isfinite(b):
        return float("nan")
    g = b * (0.62 - 0.25 * _metal_fraction(s))
    return float(np.clip(g, 1.0, 250.0))


def band_gap_ev(s: Structure) -> float:
    """Gap from ionic character; metals are gapless; crowding closes gaps."""
    vpa = _vpa(s)
    if not np.isfinite(vpa):
        return float("nan")
    mf = _metal_fraction(s)
    if mf >= 0.999:  # every species metallic -> metal
        return 0.0
    gap = 2.4 * _chi_spread(s) - 1.1
    gap -= 2.5 * _crowding(s)
    gap -= 0.02 * max(vpa - 25.0, 0.0)  # very open frameworks: closing states
    gap *= 1.0 - 0.55 * mf
    return float(np.clip(gap, 0.0, 9.0))


def formation_energy_ev_per_atom(s: Structure) -> float:
    """Ionic stabilization minus overlap penalty. Range ~[-4.5, 4]."""
    vpa = _vpa(s)
    if not np.isfinite(vpa):
        return float("nan")
    ef = -1.1 * _chi_spread(s) + 0.15
    ef += 4.0 * _crowding(s)
    ef += 0.01 * max(vpa - 30.0, 0.0)
    return float(np.clip(ef, -4.5, 4.0))


def magnetic_moment_per_atom(s: Structure) -> float:
    """Composition-mean elemental moment, damped when crowded (moment
    quenching under compression). mu_B/atom."""
    if s.num_atoms == 0:
        return float("nan")
    m = float(_MOM[np.clip(s.species, 0, 100)].mean())
    m *= 1.0 - 0.7 * _crowding(s)
    return float(np.clip(m, 0.0, 7.0))


def dielectric_constant(s: Structure) -> float:
    """Penn-like: eps = 1 + 180/(gap + 2.2)^2, capped; metals excluded via
    the gap proxy going to 0 -> large eps is clipped."""
    gap = band_gap_ev(s)
    if not np.isfinite(gap):
        return float("nan")
    eps = 1.0 + 180.0 / (gap + 2.2) ** 2
    return float(np.clip(eps, 1.0, 60.0))


# model name (the values of rewards.calculators.predictor.TASK_MODEL_DICT) -> label
LABEL_FNS = {
    "mp_bandgap": band_gap_ev,
    "mp_e_form": formation_energy_ev_per_atom,
    "mp_bulk_modulus": bulk_modulus_gpa,
    "mp_shear_modulus": shear_modulus_gpa,
    "mp_total_mag_per_atom": magnetic_moment_per_atom,
    "mp_dielectric": dielectric_constant,
}


def label_structures(structures, model_name: str) -> np.ndarray:
    fn = LABEL_FNS[model_name]
    return np.array([fn(s) for s in structures], dtype=float)
