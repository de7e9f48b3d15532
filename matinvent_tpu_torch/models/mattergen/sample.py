"""MatterGen sampler, host side (``matinvent_tpu/models/mattergen/sample.py``).

Draws num-atoms from a dataset histogram on the host, splits the batch into
size buckets (each padded to its own atom cap, so the dense O(A^2) edge work
is not spent on padding; not when it records trajectories, as in JAX), runs ``MatterGenDiffusion.sample_bucketed`` on the
model's device and returns the crystals in draw order as a ``CrystalBatch``;
``generate`` turns them into host-side sample dicts and ``Structure`` objects.
Histograms beyond the built-in ones come from ``register_num_atoms_distribution``
or from a JSON file (``num_atoms_distribution_file``).

CSP mode (``target_compositions_dict``, a list of ``{element: count}``)
cycles the fixed compositions over the batch and samples it unbucketed
with the types held (``MatterGenDiffusion.sample(fixed_types=...)``), as
the JAX sampler does; with trajectory recording it keeps the fixed types
for the DDPO replay (``last_fixed_types``).
"""
from __future__ import annotations

import functools
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from matinvent_tpu_torch.chem.composition import Composition
from matinvent_tpu_torch.chem.data import Z_BY_SYMBOL
from matinvent_tpu_torch.chem.niggli import niggli_reduce
from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.mattergen.diffusion import MatterGenDiffusion
from matinvent_tpu_torch.models.sample import ATOM_DIST, batch_to_structures

NUM_ATOMS_DISTRIBUTIONS = {k: np.asarray(v, dtype=float) for k, v in ATOM_DIST.items()}


def register_num_atoms_distribution(name: str, hist) -> None:
    """Register (or replace) a num-atoms histogram: probabilities indexed by
    atom count, or a ``{count: probability}`` mapping; normalized."""
    if isinstance(hist, dict):
        arr = np.zeros(max(int(k) for k in hist) + 1)
        for k, v in hist.items():
            arr[int(k)] = float(v)
    else:
        arr = np.asarray(hist, dtype=float)
    if arr.sum() <= 0:
        raise ValueError(f"histogram {name} has no mass")
    NUM_ATOMS_DISTRIBUTIONS[name] = arr / arr.sum()
    # one namespace for both sampler families: the DiffCSP sampler's too
    ATOM_DIST[name] = NUM_ATOMS_DISTRIBUTIONS[name]


def load_num_atoms_distributions(path: str) -> None:
    """Register every histogram of a JSON file ``{name: hist}``."""
    with open(path) as fh:
        data = json.load(fh)
    for name, hist in data.items():
        register_num_atoms_distribution(name, hist)


def _per_structure_eval_flops(cap: int, hidden: int = 256, nfreq: int = 10) -> float:
    """Matmul flops one padded structure costs per score-net eval; used only
    to weigh bucket boundaries."""
    dis = nfreq * 6
    e, n_ = cap * cap, cap
    per_layer = (
        2 * e * dis * hidden
        + 2 * 2 * n_ * hidden * hidden
        + 2 * 9 * hidden
        + 2 * e * hidden * hidden
        + 2 * n_ * 2 * hidden * hidden
        + 2 * n_ * hidden * hidden
    )
    heads = 2 * n_ * hidden * (3 + 100) + 2 * hidden * 9
    return float(per_layer + heads)


def _cap_of(v: int, max_atoms: int) -> int:
    return min(int(np.ceil(max(int(v), 1) / 4) * 4), max_atoms)


@functools.lru_cache(maxsize=64)
def _plan_bucket_rows(
    hist_key: bytes, n: int, size_buckets: int, max_atoms: int, hidden: int
) -> tuple[int, ...]:
    """Flop-optimal row counts for a sorted split of ``n`` histogram draws.

    A dynamic program over the histogram's expected counts picks the bucket
    boundaries that minimize (rows x per-eval flops at the rounded cap); each
    boundary is then pulled 3 sigma below its expected cumulative count, so
    a bucket overflows into the next cap rarely. The result depends only on
    (distribution, batch, buckets)."""
    hist = np.frombuffer(hist_key, dtype=np.float64)
    p = hist / hist.sum()
    counts = np.zeros(max_atoms + 1)
    for v in range(len(p)):
        counts[int(np.clip(v, 1, max_atoms))] += n * p[v]
    vals = [v for v in range(1, max_atoms + 1) if counts[v] > 0]
    k = min(size_buckets, len(vals))
    inf = float("inf")
    dp = [[inf] * len(vals) for _ in range(k)]
    parent = [[-1] * len(vals) for _ in range(k)]
    csum = np.cumsum([counts[v] for v in vals])

    def seg(a: int, b: int) -> float:
        return (csum[b] - (csum[a - 1] if a else 0.0)) * _per_structure_eval_flops(
            _cap_of(vals[b], max_atoms), hidden
        )

    for i in range(len(vals)):
        dp[0][i] = seg(0, i)
    for j in range(1, k):
        for i in range(j, len(vals)):
            for m in range(j - 1, i):
                c = dp[j - 1][m] + seg(m + 1, i)
                if c < dp[j][i]:
                    dp[j][i], parent[j][i] = c, m
    bound_vals = []
    i, j = len(vals) - 1, k - 1
    while j > 0:
        i = parent[j][i]
        bound_vals.append(i)
        j -= 1
    total = csum[-1]
    edges, prev = [], 0
    for i in sorted(bound_vals):
        p_le = csum[i] / total
        sd = float(np.sqrt(n * p_le * max(1.0 - p_le, 0.0)))
        e = int(np.floor(n * p_le - 3.0 * sd))
        e = min(max(e, prev), n)
        edges.append(e)
        prev = e
    rows, prev = [], 0
    for e in edges:
        rows.append(e - prev)
        prev = e
    rows.append(n - prev)
    return tuple(r for r in rows if r > 0)


def bucket_split(
    num_atoms: np.ndarray,
    size_buckets: int,
    max_atoms: int,
    hist: np.ndarray | None = None,
    hidden: int = 256,
) -> tuple[list[np.ndarray], list[int]]:
    """Sorted bucket split (index arrays) and per-bucket atom caps.

    Caps round up to a multiple of 4. With ``hist`` the row counts come from
    ``_plan_bucket_rows``, otherwise the batch is split into equal counts.
    Adjacent buckets with the same cap are merged."""
    order = np.argsort(num_atoms, kind="stable")
    if hist is not None and len(num_atoms) >= 2 * size_buckets:
        h = np.ascontiguousarray(np.asarray(hist, dtype=np.float64))
        rows = _plan_bucket_rows(h.tobytes(), len(num_atoms), size_buckets, max_atoms, hidden)
        cuts, at = [], 0
        for r in rows:
            cuts.append(order[at : at + r])
            at += r
    else:
        cuts = [c for c in np.array_split(order, size_buckets) if len(c)]
    caps = [_cap_of(int(num_atoms[idx].max()), max_atoms) for idx in cuts]
    merged_cuts, merged_caps = [cuts[0]], [caps[0]]
    for c, cap in zip(cuts[1:], caps[1:]):
        if cap == merged_caps[-1]:
            merged_cuts[-1] = np.concatenate([merged_cuts[-1], c])
        else:
            merged_cuts.append(c)
            merged_caps.append(cap)
    return merged_cuts, merged_caps


@dataclass
class MatterGenSampler:
    batch_size: int | None = None
    num_batches: int | None = None
    num_atoms_distribution: str = "mp_20"
    # JSON file of {name: histogram} registered before the name is resolved
    num_atoms_distribution_file: str | None = None
    max_atoms: int = 20
    # size buckets of the bucketed sampler; 1 samples one padded batch
    size_buckets: int = 1
    diffusion_guidance_factor: float = 0.0
    properties_to_condition_on: Dict[str, float] | None = None
    # CSP mode: compositions ({element: count}) cycled over the batch
    target_compositions_dict: List[Dict[str, float]] | None = None
    # Niggli-reduce the cells of the structures ``generate`` returns
    niggli_reduction: bool = False
    seed: int = 0
    # False runs the sampling net's plain edge branch instead of the kernel
    fused_edge: bool = True
    # record each launch's trajectory on the plain net, for DDPO; turns the
    # size buckets off
    record_trajectories: bool = False
    _generator: torch.Generator | None = field(default=None, init=False, repr=False)
    # the last recorded trajectory ([N, B, ...] tensors) and what its replay
    # needs: the clamped num-atoms, and the conditioning, guidance and fixed
    # types the behaviour policy sampled with
    last_trajectory: Any = None
    last_num_atoms: Any = None
    last_conditions: Any = None
    last_guidance: float = 0.0
    last_fixed_types: Any = None

    def __post_init__(self):
        if self.num_atoms_distribution_file:
            load_num_atoms_distributions(self.num_atoms_distribution_file)
        if self.num_atoms_distribution not in NUM_ATOMS_DISTRIBUTIONS:
            raise ValueError(
                f"num_atoms_distribution must be one of "
                f"{list(NUM_ATOMS_DISTRIBUTIONS)}, got {self.num_atoms_distribution!r}"
            )
        self._rng = np.random.default_rng(self.seed)

    def _draw_num_atoms(self, total: int) -> np.ndarray:
        dist = np.asarray(NUM_ATOMS_DISTRIBUTIONS[self.num_atoms_distribution])
        dist = dist / dist.sum()
        draws = self._rng.choice(len(dist), size=total, p=dist).astype(np.int32)
        return np.clip(draws, 1, self.max_atoms)

    def bucket_plan(self, num_atoms: np.ndarray) -> tuple[list[np.ndarray], list[int]]:
        """(cuts, caps) the bucketed launch uses."""
        return bucket_split(
            num_atoms, self.size_buckets, self.max_atoms,
            hist=np.asarray(NUM_ATOMS_DISTRIBUTIONS[self.num_atoms_distribution]),
        )

    def _composition_batch(self, total: int) -> tuple[np.ndarray, np.ndarray]:
        """CSP mode: ``[total, max_atoms]`` 1-based types and ``[total]``
        atom counts of the fixed compositions, cycled over the batch."""
        comps = [Composition({k: int(v) for k, v in c.items()})
                 for c in self.target_compositions_dict]
        types = np.zeros((total, self.max_atoms), np.int32)
        n = np.zeros(total, np.int32)
        for i in range(total):
            comp = comps[i % len(comps)]
            zs: list[int] = []
            for el, cnt in comp.counts.items():
                zs.extend([Z_BY_SYMBOL[el]] * int(cnt))
            if len(zs) > self.max_atoms:
                raise ValueError(f"composition {comp.formula} exceeds max_atoms={self.max_atoms}")
            types[i, : len(zs)] = zs
            n[i] = len(zs)
        return types, n

    def _generator_for(self, device: torch.device) -> torch.Generator:
        # one stream per sampler, continued across launches
        if self._generator is None:
            self._generator = torch.Generator(device=device).manual_seed(self.seed)
        return self._generator

    def launch(
        self, model: MatterGenDiffusion, batch_size: int | None = None,
        num_batches: int | None = None,
        target_compositions_dict: List[Dict[str, float]] | None = None,
    ) -> CrystalBatch:
        """Sample ``batch_size * num_batches`` crystals on the model's device;
        returns them in draw order, padded to ``max_atoms``. With target
        compositions (here or the sampler's) the types are held fixed."""
        batch_size = batch_size or self.batch_size
        num_batches = num_batches or self.num_batches
        if batch_size is None or num_batches is None:
            raise ValueError("batch_size and num_batches are required")
        total = batch_size * num_batches
        device = model.device
        if target_compositions_dict:
            self.target_compositions_dict = target_compositions_dict
        fixed_types = None
        if self.target_compositions_dict:
            types, num_atoms = self._composition_batch(total)
            fixed_types = torch.as_tensor(types, device=device)
        else:
            num_atoms = self._draw_num_atoms(total)
        conditions = None
        if self.properties_to_condition_on:
            conditions = {
                k: torch.full((total,), float(v), device=device)
                for k, v in self.properties_to_condition_on.items()
            }
        gen = self._generator_for(device)
        if (self.size_buckets > 1 and fixed_types is None and not self.record_trajectories
                and len(num_atoms) >= 2 * self.size_buckets):
            return self._launch_bucketed(model, num_atoms, conditions, gen)
        out = model.sample(
            gen, torch.as_tensor(num_atoms, device=device), max_atoms=self.max_atoms,
            conditions=conditions, guidance=float(self.diffusion_guidance_factor),
            fused_edge=self.fused_edge, record_traj=self.record_trajectories,
            fixed_types=fixed_types,
        )
        if not self.record_trajectories:
            return out
        final, self.last_trajectory = out
        self.last_num_atoms = final.num_atoms
        self.last_conditions = conditions
        self.last_guidance = float(self.diffusion_guidance_factor)
        self.last_fixed_types = fixed_types
        return final

    def _launch_bucketed(
        self, model: MatterGenDiffusion, num_atoms: np.ndarray, conditions, gen
    ) -> CrystalBatch:
        """Sorted-split bucketed sampling, re-padded to ``max_atoms`` and put
        back in draw order."""
        device = model.device
        cuts, caps = self.bucket_plan(num_atoms)
        na_buckets, cond_buckets = [], []
        for idx in cuts:
            na_buckets.append(torch.as_tensor(num_atoms[idx], device=device))
            sel = torch.as_tensor(idx, device=device)
            cond_buckets.append(
                None if conditions is None else {k: v[sel] for k, v in conditions.items()}
            )
        outs = model.sample_bucketed(
            gen, na_buckets, caps, conditions_buckets=cond_buckets,
            guidance=float(self.diffusion_guidance_factor), fused_edge=self.fused_edge,
        )
        A = self.max_atoms
        pad = torch.nn.functional.pad
        types = torch.cat([pad(o.atom_types, (0, A - o.atom_types.shape[1])) for o in outs])
        coords = torch.cat(
            [pad(o.frac_coords, (0, 0, 0, A - o.frac_coords.shape[1])) for o in outs]
        )
        cells = torch.cat([o.lattice for o in outs])
        nas = torch.cat([o.num_atoms for o in outs])
        inv = torch.as_tensor(np.argsort(np.concatenate(cuts), kind="stable"), device=device)
        return CrystalBatch(
            atom_types=types[inv], frac_coords=coords[inv], lattice=cells[inv],
            num_atoms=nas[inv],
        )

    def generate(
        self, model: MatterGenDiffusion, **kwargs
    ) -> Tuple[List[dict], List[Structure]]:
        """``launch``, then the crystals on the host: per-crystal dicts and
        ``Structure`` objects, in draw order (the structures' cells
        Niggli-reduced with ``niggli_reduction``)."""
        data, strucs = batch_to_structures(self.launch(model, **kwargs))
        if self.niggli_reduction:
            strucs = [niggli_reduce(s) for s in strucs]
        return data, strucs
