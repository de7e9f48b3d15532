"""Element tables of the port's host chemistry (``matinvent_tpu/chem/data.py``).

The tables the RL loop's filter and HHI reward read, as the JAX package
carries them:

* ``ATOMIC_WEIGHTS``: IUPAC standard atomic weights;
* ``ELECTRONEGATIVITY``: Pauling scale;
* ``OXIDATION_STATES``: common oxidation states (ICSD-style lists, as
  SMACT-like charge-balance screens use);
* ``METALS``: the metals of SMACT's alloy exception;
* ``CRUSTAL_ABUNDANCE_PPM``: CRC Handbook crustal abundances (ppm by mass),
  the dataset SMACT's ``crustal_abundance`` carries;
* ``HHI_PRODUCTION`` / ``HHI_RESERVE``: Herfindahl-Hirschman index of
  elemental production and reserves, Gaultois et al., Chem. Mater. 2013, 25,
  2911-2920 (the dataset pymatgen's ``HHIModel`` ships). Elements absent from
  the dataset are missing, so a composition holding one scores NaN;
* ``ELEMENT_PRICE_USD_PER_KG``: approximate prices, overridden at import by
  the public table ``element_price.csv`` beside this module.

Every table but the first four takes a ``<name>.csv`` override beside this
module (``load_table_override``).
"""
from __future__ import annotations

import csv
import os

SYMBOLS = [
    "X",
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
    "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb", "Dy",
    "Ho", "Er", "Tm", "Yb", "Lu",
    "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi",
    "Po", "At", "Rn",
    "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk",
    "Cf", "Es", "Fm",
]

Z_BY_SYMBOL = {s: z for z, s in enumerate(SYMBOLS)}

ATOMIC_WEIGHTS = {
    # "X" = placeholder/dummy species (e.g. a D3PM MASK state that survived
    # sampling); NaN mass poisons downstream properties into the failed-mask
    # path instead of crashing.
    "X": float("nan"),
    "H": 1.008, "He": 4.0026, "Li": 6.94, "Be": 9.0122, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998, "Ne": 20.180,
    "Na": 22.990, "Mg": 24.305, "Al": 26.982, "Si": 28.085, "P": 30.974,
    "S": 32.06, "Cl": 35.45, "Ar": 39.948, "K": 39.098, "Ca": 40.078,
    "Sc": 44.956, "Ti": 47.867, "V": 50.942, "Cr": 51.996, "Mn": 54.938,
    "Fe": 55.845, "Co": 58.933, "Ni": 58.693, "Cu": 63.546, "Zn": 65.38,
    "Ga": 69.723, "Ge": 72.630, "As": 74.922, "Se": 78.971, "Br": 79.904,
    "Kr": 83.798, "Rb": 85.468, "Sr": 87.62, "Y": 88.906, "Zr": 91.224,
    "Nb": 92.906, "Mo": 95.95, "Tc": 98.0, "Ru": 101.07, "Rh": 102.91,
    "Pd": 106.42, "Ag": 107.87, "Cd": 112.41, "In": 114.82, "Sn": 118.71,
    "Sb": 121.76, "Te": 127.60, "I": 126.90, "Xe": 131.29, "Cs": 132.91,
    "Ba": 137.33, "La": 138.91, "Ce": 140.12, "Pr": 140.91, "Nd": 144.24,
    "Pm": 145.0, "Sm": 150.36, "Eu": 151.96, "Gd": 157.25, "Tb": 158.93,
    "Dy": 162.50, "Ho": 164.93, "Er": 167.26, "Tm": 168.93, "Yb": 173.05,
    "Lu": 174.97, "Hf": 178.49, "Ta": 180.95, "W": 183.84, "Re": 186.21,
    "Os": 190.23, "Ir": 192.22, "Pt": 195.08, "Au": 196.97, "Hg": 200.59,
    "Tl": 204.38, "Pb": 207.2, "Bi": 208.98, "Po": 209.0, "At": 210.0,
    "Rn": 222.0, "Fr": 223.0, "Ra": 226.0, "Ac": 227.0, "Th": 232.04,
    "Pa": 231.04, "U": 238.03, "Np": 237.0, "Pu": 244.0, "Am": 243.0,
    "Cm": 247.0, "Bk": 247.0, "Cf": 251.0, "Es": 252.0, "Fm": 257.0,
}

ELECTRONEGATIVITY = {
    "H": 2.20, "Li": 0.98, "Be": 1.57, "B": 2.04, "C": 2.55, "N": 3.04,
    "O": 3.44, "F": 3.98, "Na": 0.93, "Mg": 1.31, "Al": 1.61, "Si": 1.90,
    "P": 2.19, "S": 2.58, "Cl": 3.16, "K": 0.82, "Ca": 1.00, "Sc": 1.36,
    "Ti": 1.54, "V": 1.63, "Cr": 1.66, "Mn": 1.55, "Fe": 1.83, "Co": 1.88,
    "Ni": 1.91, "Cu": 1.90, "Zn": 1.65, "Ga": 1.81, "Ge": 2.01, "As": 2.18,
    "Se": 2.55, "Br": 2.96, "Kr": 3.00, "Rb": 0.82, "Sr": 0.95, "Y": 1.22,
    "Zr": 1.33, "Nb": 1.60, "Mo": 2.16, "Tc": 1.90, "Ru": 2.20, "Rh": 2.28,
    "Pd": 2.20, "Ag": 1.93, "Cd": 1.69, "In": 1.78, "Sn": 1.96, "Sb": 2.05,
    "Te": 2.10, "I": 2.66, "Xe": 2.60, "Cs": 0.79, "Ba": 0.89, "La": 1.10,
    "Ce": 1.12, "Pr": 1.13, "Nd": 1.14, "Pm": 1.13, "Sm": 1.17, "Eu": 1.20,
    "Gd": 1.20, "Tb": 1.10, "Dy": 1.22, "Ho": 1.23, "Er": 1.24, "Tm": 1.25,
    "Yb": 1.10, "Lu": 1.27, "Hf": 1.30, "Ta": 1.50, "W": 2.36, "Re": 1.90,
    "Os": 2.20, "Ir": 2.20, "Pt": 2.28, "Au": 2.54, "Hg": 2.00, "Tl": 1.62,
    "Pb": 2.33, "Bi": 2.02, "Po": 2.00, "At": 2.20, "Fr": 0.70, "Ra": 0.90,
    "Ac": 1.10, "Th": 1.30, "Pa": 1.50, "U": 1.38, "Np": 1.36, "Pu": 1.28,
    "Am": 1.13, "Cm": 1.28,
}

# Common oxidation states per element (screening-grade ICSD-style lists).
OXIDATION_STATES = {
    "H": [-1, 1], "He": [], "Li": [1], "Be": [2], "B": [3, -3],
    "C": [-4, -3, -2, -1, 1, 2, 3, 4], "N": [-3, -2, -1, 1, 2, 3, 4, 5],
    "O": [-2, -1], "F": [-1], "Ne": [],
    "Na": [1], "Mg": [2], "Al": [3], "Si": [-4, 4], "P": [-3, 3, 5],
    "S": [-2, 2, 4, 6], "Cl": [-1, 1, 3, 5, 7], "Ar": [],
    "K": [1], "Ca": [2], "Sc": [3], "Ti": [2, 3, 4], "V": [2, 3, 4, 5],
    "Cr": [2, 3, 6], "Mn": [2, 3, 4, 6, 7], "Fe": [2, 3], "Co": [2, 3],
    "Ni": [2, 3], "Cu": [1, 2], "Zn": [2], "Ga": [3], "Ge": [-4, 2, 4],
    "As": [-3, 3, 5], "Se": [-2, 2, 4, 6], "Br": [-1, 1, 3, 5, 7], "Kr": [2],
    "Rb": [1], "Sr": [2], "Y": [3], "Zr": [2, 4], "Nb": [3, 5],
    "Mo": [2, 3, 4, 5, 6], "Tc": [4, 7], "Ru": [2, 3, 4, 8], "Rh": [1, 3],
    "Pd": [2, 4], "Ag": [1, 2], "Cd": [2], "In": [1, 3], "Sn": [-4, 2, 4],
    "Sb": [-3, 3, 5], "Te": [-2, 2, 4, 6], "I": [-1, 1, 3, 5, 7], "Xe": [2, 4, 6],
    "Cs": [1], "Ba": [2], "La": [3], "Ce": [3, 4], "Pr": [3, 4], "Nd": [2, 3],
    "Pm": [3], "Sm": [2, 3], "Eu": [2, 3], "Gd": [3], "Tb": [3, 4], "Dy": [2, 3],
    "Ho": [3], "Er": [3], "Tm": [2, 3], "Yb": [2, 3], "Lu": [3],
    "Hf": [4], "Ta": [3, 5], "W": [2, 3, 4, 5, 6], "Re": [2, 4, 6, 7],
    "Os": [2, 3, 4, 6, 8], "Ir": [1, 3, 4], "Pt": [2, 4], "Au": [1, 3],
    "Hg": [1, 2], "Tl": [1, 3], "Pb": [-4, 2, 4], "Bi": [3, 5], "Po": [-2, 2, 4],
    "At": [-1, 1], "Rn": [2], "Fr": [1], "Ra": [2], "Ac": [3], "Th": [4],
    "Pa": [4, 5], "U": [3, 4, 5, 6], "Np": [3, 4, 5, 6, 7], "Pu": [3, 4, 5, 6],
    "Am": [2, 3, 4], "Cm": [3, 4],
}

# Metallic elements (for the SMACT alloy exception: all-metal compositions
# are accepted without a charge-balance requirement).
METALS = set(
    """Li Be Na Mg Al K Ca Sc Ti V Cr Mn Fe Co Ni Cu Zn Ga Rb Sr Y Zr Nb Mo Tc
    Ru Rh Pd Ag Cd In Sn Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf
    Ta W Re Os Ir Pt Au Hg Tl Pb Bi Po Fr Ra Ac Th Pa U Np Pu Am Cm""".split()
)

CRUSTAL_ABUNDANCE_PPM = {
    "O": 461000.0, "Si": 282000.0, "Al": 82300.0, "Fe": 56300.0, "Ca": 41500.0,
    "Na": 23600.0, "Mg": 23300.0, "K": 20900.0, "Ti": 5650.0, "H": 1400.0,
    "P": 1050.0, "Mn": 950.0, "F": 585.0, "Ba": 425.0, "Sr": 370.0, "S": 350.0,
    "C": 200.0, "Zr": 165.0, "Cl": 145.0, "V": 120.0, "Cr": 102.0, "Rb": 90.0,
    "Ni": 84.0, "Zn": 70.0, "Ce": 66.5, "Cu": 60.0, "Nd": 41.5, "La": 39.0,
    "Y": 33.0, "Co": 25.0, "Sc": 22.0, "Li": 20.0, "Nb": 20.0, "N": 19.0,
    "Ga": 19.0, "Pb": 14.0, "B": 10.0, "Th": 9.6, "Pr": 9.2, "Sm": 7.05,
    "Gd": 6.2, "Dy": 5.2, "Er": 3.5, "Yb": 3.2, "Hf": 3.0, "Cs": 3.0,
    "Be": 2.8, "U": 2.7, "Br": 2.4, "Sn": 2.3, "Eu": 2.0, "Ta": 2.0,
    "As": 1.8, "Ge": 1.5, "Ho": 1.3, "W": 1.25, "Tb": 1.2, "Mo": 1.2,
    "Tl": 0.85, "Lu": 0.8, "Tm": 0.52, "I": 0.45, "In": 0.25, "Sb": 0.2,
    "Cd": 0.15, "Hg": 0.085, "Ag": 0.075, "Se": 0.05, "Pd": 0.015,
    "Bi": 0.0085, "Pt": 0.005, "Au": 0.004, "Os": 0.0015, "Ir": 0.001,
    "Ru": 0.001, "Rh": 0.001, "Te": 0.001, "Re": 0.0007,
}

# Herfindahl-Hirschman index of elemental supply concentration (0..10000,
# higher = more concentrated supply)
HHI_PRODUCTION = {
    "H": 1200.0, "Li": 2900.0, "Be": 8000.0, "B": 2900.0, "C": 500.0,
    "N": 1300.0, "O": 500.0, "F": 7000.0, "Na": 1100.0, "Mg": 5300.0,
    "Al": 1600.0, "Si": 4700.0, "P": 2000.0, "S": 700.0, "Cl": 1500.0,
    "K": 1700.0, "Ca": 3900.0, "Sc": 5500.0, "Ti": 1100.0, "V": 3300.0,
    "Cr": 3100.0, "Mn": 1600.0, "Fe": 2400.0, "Co": 3100.0, "Ni": 1000.0,
    "Cu": 1600.0, "Zn": 1600.0, "Ga": 5500.0, "Ge": 5300.0, "As": 3300.0,
    "Se": 2200.0, "Br": 3300.0, "Rb": 6000.0, "Sr": 4200.0, "Y": 9800.0,
    "Zr": 3400.0, "Nb": 8500.0, "Mo": 2400.0, "Ru": 3200.0, "Rh": 3200.0,
    "Pd": 3200.0, "Ag": 1200.0, "Cd": 1700.0, "In": 3300.0, "Sn": 2600.0,
    "Sb": 7900.0, "Te": 2900.0, "I": 4900.0, "Cs": 6000.0, "Ba": 3000.0,
    "La": 9500.0, "Ce": 9500.0, "Pr": 9500.0, "Nd": 9500.0, "Sm": 9500.0,
    "Eu": 9500.0, "Gd": 9500.0, "Tb": 9500.0, "Dy": 9500.0, "Ho": 9500.0,
    "Er": 9500.0, "Tm": 9500.0, "Yb": 9500.0, "Lu": 9500.0, "Hf": 3400.0,
    "Ta": 2300.0, "W": 7000.0, "Re": 3300.0, "Os": 5500.0, "Ir": 5500.0,
    "Pt": 5500.0, "Au": 1100.0, "Hg": 5500.0, "Tl": 6500.0, "Pb": 2700.0,
    "Bi": 5300.0,
}

HHI_RESERVE = {
    "H": 500.0, "Li": 4200.0, "Be": 4000.0, "B": 2300.0, "C": 500.0,
    "N": 500.0, "O": 500.0, "F": 1500.0, "Na": 500.0, "Mg": 500.0,
    "Al": 1000.0, "Si": 1000.0, "P": 5100.0, "S": 1000.0, "Cl": 1500.0,
    "K": 7200.0, "Ca": 1500.0, "Sc": 4500.0, "Ti": 1600.0, "V": 3400.0,
    "Cr": 4100.0, "Mn": 1800.0, "Fe": 1400.0, "Co": 2700.0, "Ni": 1500.0,
    "Cu": 1500.0, "Zn": 1900.0, "Ga": 1900.0, "Ge": 1900.0, "As": 4000.0,
    "Se": 2100.0, "Br": 6900.0, "Rb": 6000.0, "Sr": 3000.0, "Y": 2600.0,
    "Zr": 2600.0, "Nb": 8800.0, "Mo": 5300.0, "Ru": 8000.0, "Rh": 8000.0,
    "Pd": 8000.0, "Ag": 1400.0, "Cd": 1300.0, "In": 2000.0, "Sn": 1600.0,
    "Sb": 3400.0, "Te": 4900.0, "I": 4800.0, "Cs": 6000.0, "Ba": 2300.0,
    "La": 3100.0, "Ce": 3100.0, "Pr": 3100.0, "Nd": 3100.0, "Sm": 3100.0,
    "Eu": 3100.0, "Gd": 3100.0, "Tb": 3100.0, "Dy": 3100.0, "Ho": 3100.0,
    "Er": 3100.0, "Tm": 3100.0, "Yb": 3100.0, "Lu": 3100.0, "Hf": 2600.0,
    "Ta": 4800.0, "W": 4200.0, "Re": 3300.0, "Os": 9100.0, "Ir": 9100.0,
    "Pt": 9100.0, "Au": 1000.0, "Hg": 3100.0, "Tl": 6500.0, "Pb": 1800.0,
    "Bi": 6000.0,
}

# Approximate element prices in USD/kg (screening-grade; override with
# element_price.csv for production use).
ELEMENT_PRICE_USD_PER_KG = {
    "H": 1.4, "He": 24.0, "Li": 85.0, "Be": 850.0, "B": 3.7, "C": 0.12,
    "N": 0.14, "O": 0.15, "F": 2.0, "Na": 3.0, "Mg": 2.3, "Al": 1.8,
    "Si": 1.7, "P": 2.7, "S": 0.1, "Cl": 0.15, "K": 12.0, "Ca": 2.3,
    "Sc": 3500.0, "Ti": 11.0, "V": 25.0, "Cr": 9.4, "Mn": 1.8, "Fe": 0.1,
    "Co": 33.0, "Ni": 14.0, "Cu": 9.0, "Zn": 2.5, "Ga": 280.0, "Ge": 1000.0,
    "As": 1.2, "Se": 22.0, "Br": 4.4, "Rb": 15000.0, "Sr": 6.6, "Y": 31.0,
    "Zr": 36.0, "Nb": 73.0, "Mo": 40.0, "Ru": 10000.0, "Rh": 147000.0,
    "Pd": 50000.0, "Ag": 800.0, "Cd": 2.7, "In": 240.0, "Sn": 25.0,
    "Sb": 12.0, "Te": 64.0, "I": 35.0, "Cs": 61000.0, "Ba": 0.26,
    "La": 4.9, "Ce": 4.7, "Pr": 95.0, "Nd": 110.0, "Sm": 14.0, "Eu": 280.0,
    "Gd": 55.0, "Tb": 1300.0, "Dy": 350.0, "Ho": 160.0, "Er": 95.0,
    "Tm": 3000.0, "Yb": 170.0, "Lu": 4500.0, "Hf": 900.0, "Ta": 300.0,
    "W": 35.0, "Re": 1600.0, "Os": 12000.0, "Ir": 160000.0, "Pt": 30000.0,
    "Au": 60000.0, "Hg": 30.0, "Tl": 4200.0, "Pb": 2.0, "Bi": 6.0,
    "Th": 290.0, "U": 100.0,
}


def load_table_override(name: str, table: dict) -> dict:
    """``table`` with the rows of ``<name>.csv`` beside this module
    (``symbol,value``; other rows are skipped) merged over it."""
    path = os.path.join(os.path.dirname(__file__), f"{name}.csv")
    if not os.path.exists(path):
        return table
    out = dict(table)
    with open(path) as fh:
        for row in csv.reader(fh):
            if len(row) >= 2 and row[0] in Z_BY_SYMBOL:
                out[row[0]] = float(row[1])
    return out


HHI_PRODUCTION = load_table_override("hhi_production", HHI_PRODUCTION)
HHI_RESERVE = load_table_override("hhi_reserve", HHI_RESERVE)
ELEMENT_PRICE_USD_PER_KG = load_table_override("element_price", ELEMENT_PRICE_USD_PER_KG)
