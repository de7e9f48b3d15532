"""Sample filters and generation-quality metrics (``matinvent_tpu/pipeline/filters.py``).

``invalid_filter`` (structural, charge-balance and cell-size checks),
``OptFilter`` (novelty, uniqueness and stability masks, AND-ed over the
chosen metrics, the ``synthesizable`` screen of the SynScore ensemble
among them) and ``OptEval`` (the metrics only). With ``relax`` and a
``relaxer`` (a callable ``structures -> (relaxed, energies)``, such as
``chem.relax.SoftSphereRelaxer``) both relax the structures first when no
energies are given, and the stability screen reads the relaxer's energies;
``relax=True`` without a relaxer relaxes nothing, as in the JAX package.
"""
from __future__ import annotations

import json
import logging
import multiprocessing as mp
from typing import Callable, List, Literal, Sequence

import numpy as np

from matinvent_tpu_torch.chem.ehull import ConvexHullReference, PhaseEntry, stable_mask
from matinvent_tpu_torch.chem.matcher import (
    DisorderedStructureMatcher,
    OrderedStructureMatcher,
    StructureMatcher,
)
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz
from matinvent_tpu_torch.chem.validity import cell_size_ok, smact_valid, structure_validity
from matinvent_tpu_torch.rewards.calculators.syn_score import SynScore

#: structure_matcher values: "ordered" and "disordered" are the exact tiers
#: (pymatgen semantics), "fast" the fingerprint approximation
MATCHER_TIERS = {
    "ordered": OrderedStructureMatcher,
    "disordered": DisorderedStructureMatcher,
    "fast": StructureMatcher,
}

METRIC_LIST = ["validity", "novel", "unique", "stable", "synthesizable"]


def _validity_checks(s: Structure) -> bool:
    return structure_validity(s) and smact_valid(s) and cell_size_ok(s)


def invalid_filter(
    sample_data: list,
    sample_struc: List[Structure],
    return_mask: bool = False,
    num_workers: int | None = None,
):
    """Drop the samples that fail the structural, charge-balance or
    cell-size check (or return the keep mask); ``num_workers`` spawned
    processes share a batch of more than 64."""
    if num_workers and num_workers > 1 and len(sample_struc) > 64:
        with mp.get_context("spawn").Pool(num_workers) as pool:
            mask = np.array(pool.map(_validity_checks, sample_struc), dtype=bool)
    else:
        mask = np.array([_validity_checks(s) for s in sample_struc], dtype=bool)
    if return_mask:
        return mask
    return (
        [x for x, m in zip(sample_data, mask) if m],
        [x for x, m in zip(sample_struc, mask) if m],
    )


class ReferenceDataset:
    """Known structures (novelty) and known-phase energies (stability, on a
    convex hull)."""

    def __init__(
        self,
        structures: Sequence[Structure] | None = None,
        phase_entries: Sequence | None = None,
    ):
        self.structures = list(structures or [])
        entries = [
            e if isinstance(e, PhaseEntry) else PhaseEntry.make(e[0], e[1])
            for e in (phase_entries or [])
        ]
        self.hull = ConvexHullReference(entries) if entries else None

    @classmethod
    def from_files(
        cls, structures_path: str | None = None, energies_path: str | None = None
    ) -> "ReferenceDataset":
        """From an extxyz file (novelty structures) and/or a JSON file mapping
        formula -> energy per atom (the stability hull)."""
        structures = read_extxyz(structures_path) if structures_path else []
        entries = []
        if energies_path:
            with open(energies_path) as fh:
                entries = list(json.load(fh).items())
        return cls(structures=structures, phase_entries=entries)

    @property
    def known_elements(self) -> set[str]:
        els: set[str] = set()
        for s in self.structures:
            els.update(s.composition.elements)
        if self.hull is not None:
            els |= self.hull.known_elements
        return els


class OptFilter:
    """Metric-based sample filter.

    Args:
        metrics: subset of ``METRIC_LIST`` to AND together.
        relax: whether to run ``relaxer`` before the metrics.
        relaxer: callable ``(structures) -> (relaxed_structures, energies)``.
        reference: ``ReferenceDataset`` for novelty and stability.
        stability_fn: ``(structures, energies, reference) -> mask``; by
            default energy above the reference hull <= ``ehull_threshold``.
        structure_matcher: a key of ``MATCHER_TIERS``.
        syn_calculator, syn_threshold: the synthesizability screen keeps
            scores >= ``syn_threshold`` (NaN counts as 0); by default a
            ``SynScore`` on ``device``, skipped with a warning when its
            ensemble is untrained.
    """

    def __init__(
        self,
        metrics: List[str],
        relax: bool = True,
        relaxer: Callable | None = None,
        reference: ReferenceDataset | None = None,
        stability_fn: Callable | None = None,
        structure_matcher: Literal["ordered", "disordered", "fast"] = "disordered",
        num_workers: int | None = None,
        ehull_threshold: float = 0.1,
        syn_calculator=None,
        syn_threshold: float = 0.5,
        device=None,
    ) -> None:
        if not all(m in METRIC_LIST for m in metrics):
            raise ValueError(f"metrics must be in {METRIC_LIST}, got {metrics}")
        self.metrics = metrics
        self.relax = relax
        self.relaxer = relaxer
        self.reference = reference or ReferenceDataset()
        self.stability_fn = stability_fn
        self.matcher = MATCHER_TIERS[structure_matcher]()
        self.num_workers = num_workers
        self.ehull_threshold = ehull_threshold
        if "synthesizable" in metrics and syn_calculator is None:
            syn_calculator = SynScore(root_dir="rewards/syn_filter", device=device)
        if "synthesizable" in metrics and not getattr(syn_calculator, "trained", True):
            # as for stability below: never gate samples on random-init scores
            logging.warning(
                "'synthesizable' metric requested but the SynScore ensemble "
                "has no trained weights (random init); skipping the "
                "synthesizability screen"
            )
            syn_calculator = None
        self.syn_calculator = syn_calculator
        self.syn_threshold = syn_threshold

    def pre_filter_elements(
        self, data_list: list, structures: List[Structure], energies: List[float] | None = None
    ):
        """Drop the samples holding an element the reference does not know
        (and their energies); a no-op without a reference."""
        known = self.reference.known_elements
        if not known:
            return data_list, structures, energies
        mask = [set(s.composition.elements) <= known for s in structures]
        return (
            [x for x, m in zip(data_list, mask) if m],
            [x for x, m in zip(structures, mask) if m],
            None if energies is None else [e for e, m in zip(energies, mask) if m],
        )

    def _relaxed(self, structures: List[Structure], energies: List[float] | None):
        """(structures, energies), relaxed by ``relaxer`` when ``relax`` is
        set and no energies were given."""
        if self.relax and self.relaxer is not None and energies is None:
            return self.relaxer(structures)
        return structures, energies

    def compute_metrics(
        self, structures: List[Structure], energies: List[float] | None
    ) -> tuple[dict, dict]:
        """(masks, ``frac_<metric>`` values) of ``structures``."""
        masks: dict[str, np.ndarray] = {}
        n = len(structures)
        if n == 0:
            return {}, {}
        masks["validity"] = invalid_filter(
            structures, structures, return_mask=True, num_workers=self.num_workers
        )
        feats = self.matcher.features(structures)
        masks["unique"] = self.matcher.unique_mask(structures, feats)
        if self.reference.structures:
            masks["novel"] = self.matcher.novel_mask(structures, self.reference.structures, feats)
        else:
            masks["novel"] = np.ones(n, dtype=bool)
        if self.stability_fn is not None and energies is not None:
            masks["stable"] = np.asarray(
                self.stability_fn(structures, energies, self.reference), dtype=bool
            )
        elif energies is not None and self.reference.hull is not None:
            masks["stable"] = stable_mask(
                structures, energies, self.reference.hull, threshold=self.ehull_threshold
            )
        elif "stable" in self.metrics:
            # never report stability that was not evaluated: without energies
            # and a hull the metric is skipped and left out of the AND
            logging.warning(
                "'stable' metric requested but no energies/reference hull "
                "available; skipping stability screen"
            )
        if self.syn_calculator is not None:
            scores = np.asarray(
                self.syn_calculator.calc((structures, None), "opt_filter"), dtype=float
            )
            masks["synthesizable"] = np.nan_to_num(scores, nan=0.0) >= self.syn_threshold
        metric_values = {f"frac_{k}": float(v.mean()) for k, v in masks.items()}
        if "stable" in masks:
            sun = masks["stable"] & masks["unique"] & masks["novel"]
            metric_values["frac_sun"] = float(sun.mean())
        return masks, metric_values

    def __call__(
        self, data_list: list, structures: List[Structure], energies: List[float] | None = None
    ):
        """(kept data, kept structures, metrics)."""
        data_list, structures, energies = self.pre_filter_elements(
            data_list, structures, energies
        )
        structures, energies = self._relaxed(structures, energies)
        masks, metrics = self.compute_metrics(structures, energies)
        if not masks:
            return [], [], {}
        selected = [masks[m] for m in self.metrics if m in masks]
        if not selected:
            return data_list, structures, metrics
        mask_all = np.logical_and.reduce(selected)
        return (
            [x for x, m in zip(data_list, mask_all) if m],
            [x for x, m in zip(structures, mask_all) if m],
            metrics,
        )


class OptEval(OptFilter):
    """The metrics of ``OptFilter`` without filtering."""

    def __init__(self, **kwargs):
        kwargs.setdefault("metrics", METRIC_LIST[:4])
        super().__init__(**kwargs)

    def __call__(self, structures: List[Structure], energies: List[float] | None = None):
        """(metrics, the structures they were computed on)."""
        _, structures, energies = self.pre_filter_elements(structures, structures, energies)
        structures, energies = self._relaxed(structures, energies)
        _, metrics = self.compute_metrics(structures, energies)
        return metrics, structures


def build_filter(cfg: dict | None, device=None, syn_root_dir: str | None = None) -> OptFilter | None:
    """An ``OptFilter`` from the port's plain-dict config: its keyword
    arguments, with ``reference`` given as ``ReferenceDataset.from_files``
    paths (``structures_path``, ``energies_path``) and ``relaxer`` as a
    relaxer object (``pipeline.mat_invent.build_relaxer`` makes one from its
    config); ``None`` for no filter.
    ``device`` and ``syn_root_dir`` (where its scores are written) are the
    default synthesizability screen's. An ``OptFilter`` (the config entry
    point's ``instantiate`` builds one) is returned as it is."""
    if not cfg:
        return None
    if isinstance(cfg, OptFilter):
        return cfg
    if not isinstance(cfg, dict):
        raise TypeError(f"sample_cfg filter must be a dict of OptFilter arguments, got {cfg!r}")
    kwargs = dict(cfg)
    ref = kwargs.pop("reference", None)
    if ref is not None:
        kwargs["reference"] = ReferenceDataset.from_files(**ref)
    kwargs.setdefault("device", device)
    if ("synthesizable" in kwargs.get("metrics", ()) and syn_root_dir is not None
            and kwargs.get("syn_calculator") is None):
        kwargs["syn_calculator"] = SynScore(root_dir=syn_root_dir, device=kwargs["device"])
    return OptFilter(**kwargs)
