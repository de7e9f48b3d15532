"""Sample filters (``matinvent_tpu/pipeline/filters.py``): ``invalid_filter``
only. ``OptFilter`` and ``OptEval`` need the structure matcher, which is
not ported."""
from __future__ import annotations

from typing import List

import numpy as np

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.chem.validity import cell_size_ok, smact_valid, structure_validity


def _validity_checks(s: Structure) -> bool:
    return structure_validity(s) and smact_valid(s) and cell_size_ok(s)


def invalid_filter(sample_data: list, sample_struc: List[Structure], return_mask: bool = False):
    """Drop the samples that fail the structural, charge-balance or
    cell-size check (or return the keep mask)."""
    mask = np.array([_validity_checks(s) for s in sample_struc], dtype=bool)
    if return_mask:
        return mask
    return (
        [x for x, m in zip(sample_data, mask) if m],
        [x for x, m in zip(sample_struc, mask) if m],
    )
