"""Sampler helpers shared by the model families (``matinvent_tpu/models/sample.py``).

The num-atoms histograms of the training datasets (dataset statistics, not
code: probabilities indexed by atom count), and the conversions between a
padded batch and host-side per-crystal dicts and ``Structure`` objects.
"""
from __future__ import annotations

from typing import List, Tuple

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.models.batch import CrystalBatch

ATOM_DIST = {
    "perov_5": [0, 0, 0, 0, 0, 1],
    "carbon_24": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                  0.3250697750779839, 0.0, 0.27795107535708424, 0.0,
                  0.15383352487276308, 0.0, 0.11246100804465604, 0.0,
                  0.04958134953209654, 0.0, 0.038745690362830404, 0.0,
                  0.019044491873255624, 0.0, 0.010178952552946971, 0.0,
                  0.007059596125430964, 0.0, 0.006074536200952225],
    "mp_20": [0.0, 0.0021742334905660377, 0.021079009433962265,
              0.019826061320754717, 0.15271226415094338, 0.047132959905660375,
              0.08464770047169812, 0.021079009433962265, 0.07808814858490566,
              0.03434551886792453, 0.0972877358490566, 0.013303360849056603,
              0.09669811320754718, 0.02155807783018868, 0.06522700471698113,
              0.014372051886792452, 0.06703272405660378, 0.00972877358490566,
              0.053176591981132074, 0.010576356132075472, 0.08995430424528301],
    # derived from the largest in-repo corpus (experiments/data/
    # reference.extxyz, 2000 motif-based ionic structures)
    "matinvent_corpus": [0.0, 0.0, 0.5205, 0.2115, 0.268],
}


def batch_to_structures(batch: CrystalBatch) -> Tuple[List[dict], List[Structure]]:
    """Split a padded batch into host per-crystal dicts and Structures."""
    data_list = batch.to_lists()
    strucs = [Structure(d["lattice"], d["atom_types"], d["frac_coords"]) for d in data_list]
    return data_list, strucs


def collate_data_list(data_list: List[dict], max_atoms: int) -> CrystalBatch:
    """Host per-crystal dicts -> a padded (CPU) batch, for the fine-tune."""
    return CrystalBatch.from_lists(
        [d["atom_types"] for d in data_list],
        [d["frac_coords"] for d in data_list],
        [d["lattice"] for d in data_list],
        max_atoms=max_atoms,
    )
