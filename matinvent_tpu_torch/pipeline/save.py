"""Structure saving (``matinvent_tpu/pipeline/save.py``)."""
from __future__ import annotations

import os
from typing import Sequence

from matinvent_tpu_torch.chem.structure import Structure, save_extxyz


def save_structures(structures: Sequence[Structure], save_dir: str, filename: str) -> str:
    """Write structures to ``save_dir/filename`` as extxyz; returns the
    absolute path."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(save_dir, filename))
    save_extxyz(list(structures), path)
    return path
