"""Host-side k-nearest periodic graph and line graph, ALIGNN's
(``matinvent_tpu/rewards/calculators/alignn/graphs.py``).

The graph the published ALIGNN checkpoints were trained on
(``jarvis.core.graphs`` / ``alignn.graphs.Graph.atom_dgl_multigraph`` with
``neighbor_strategy="k-nearest"``, ``cutoff=8``, ``max_neighbors=12``,
``use_canonize=True``), built as the JAX package builds it, integer for
integer:

* neighbor lists within ``cutoff``, widened to ``max(a, b, c)`` and then
  by doubling until every atom sees at least ``max_neighbors`` neighbors;
* per atom every bond no longer than the ``max_neighbors``-th nearest
  (ties included: the degree can exceed 12);
* canonical (src <= dst, src image at 0) dedup of periodic images, then
  both directed edges per canonical pair;
* the line graph with backtracking pairs (DGL's ``line_graph`` default)
  and the bond cosine ``(-r_a) . r_b / |r_a| |r_b|`` of the edge pair
  a = (i->j), b = (j->k).

One guard JAX's builder lacks: a cell so flat or skewed that the image
search would need more than ``MAX_IMAGE_BYTES`` (8 GiB) of displacements
raises ``ValueError`` (the calculator's NaN) instead of exhausting the
host's memory; below it the two builders agree exactly.

It is numpy on the host (data-dependent and ragged); ``build_batch`` gives
the device forward (``.model``) one flat padded ``ALIGNNBatch`` with masks.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import List, Sequence

import numpy as np

from matinvent_tpu_torch.chem.structure import Structure


# the neighbour search's working set beyond which a cell is refused (JAX's
# builder has no bound and runs the host out of memory there)
MAX_IMAGE_BYTES = 8 * 2**30


def _all_neighbors(structure: Structure, r: float):
    """For each atom i: arrays (j, distance, image) of every atom-image within
    ``r`` (self-image at distance ~0 excluded), mirroring
    ``jarvis.core.atoms.Atoms.get_all_neighbors``."""
    lat = structure.lattice  # rows = cell vectors; cart = frac @ lat
    frac = structure.frac_coords
    A = len(frac)
    inv = np.linalg.inv(lat)
    # plane spacing along each lattice direction = 1/||column_i of lat^-1||
    spacing = 1.0 / np.linalg.norm(inv, axis=0)
    nmax = np.ceil(r / spacing).astype(int) + 1
    # the [A, A, images, 3] displacements must fit in host memory: a flat
    # or skewed cell (a plane spacing far below the cutoff) is refused
    images = float(np.prod(2.0 * nmax + 1.0))
    if A * A * images * 3 * 8 > MAX_IMAGE_BYTES:
        raise ValueError(f"{images:.3g} periodic images of {A} atoms within {r} A: "
                         "the cell is too flat or skewed for the neighbour search")
    images = np.array(
        list(
            product(
                range(-nmax[0], nmax[0] + 1),
                range(-nmax[1], nmax[1] + 1),
                range(-nmax[2], nmax[2] + 1),
            )
        ),
        dtype=np.float64,
    )  # [M, 3]
    # displacement i -> (j, image): frac_j + im - frac_i
    diff = frac[None, :, None, :] + images[None, None, :, :] - frac[:, None, None, :]
    cart = diff @ lat  # [A, A, M, 3]
    dist = np.linalg.norm(cart, axis=-1)  # [A, A, M]
    out = []
    for i in range(A):
        jj, mm = np.where((dist[i] <= r) & (dist[i] > 1e-8))
        out.append((jj, dist[i, jj, mm], images[mm].astype(np.int64)))
    return out


def _canonize(src: int, dst: int, image: tuple) -> tuple:
    """jarvis ``canonize_edge``: store src<=dst with the src image at 0."""
    if dst < src:
        # swapping endpoints moves the image to the (new) dst and negates it
        src, dst = dst, src
        image = tuple(-x for x in image)
    return src, dst, image


def knn_edges(
    structure: Structure,
    cutoff: float = 8.0,
    max_neighbors: int = 12,
    max_attempts: int = 5,
):
    """Directed periodic edges (src, dst, cart displacement r) of the
    canonized k-nearest graph; both directions per canonical bond."""
    r = float(cutoff)
    for _ in range(max_attempts):
        nbrs = _all_neighbors(structure, r)
        if min(len(n[0]) for n in nbrs) >= max_neighbors:
            break
        lengths = structure.lengths
        r = float(max(lengths)) if r < max(lengths) else 2.0 * r
    else:
        raise ValueError(
            f"could not find {max_neighbors} neighbors within {r} A "
            f"after {max_attempts} cutoff expansions"
        )

    canonical: dict[tuple, set] = {}
    for i, (jj, dd, imgs) in enumerate(nbrs):
        order = np.argsort(dd, kind="stable")
        jj, dd, imgs = jj[order], dd[order], imgs[order]
        max_dist = dd[max_neighbors - 1]
        keep = dd <= max_dist  # ties at the k-th distance INCLUDED
        for j, img in zip(jj[keep], imgs[keep]):
            s, d, im = _canonize(i, int(j), tuple(int(x) for x in img))
            canonical.setdefault((s, d), set()).add(im)

    lat = structure.lattice
    frac = structure.frac_coords
    src, dst, vec = [], [], []
    for (s, d) in sorted(canonical):
        for im in sorted(canonical[(s, d)]):
            disp = (frac[d] + np.asarray(im, np.float64) - frac[s]) @ lat
            src.append(s); dst.append(d); vec.append(disp)
            src.append(d); dst.append(s); vec.append(-disp)
    return (
        np.asarray(src, np.int64),
        np.asarray(dst, np.int64),
        np.asarray(vec, np.float64).reshape(-1, 3),
    )


def line_graph_pairs(src: np.ndarray, dst: np.ndarray):
    """Line-graph edges (a, b): directed bond a=(i->j) feeding b=(j->k),
    backtracking pairs included (DGL ``line_graph`` default)."""
    by_src: dict[int, list[int]] = {}
    for e, s in enumerate(src):
        by_src.setdefault(int(s), []).append(e)
    aa, bb = [], []
    for a in range(len(src)):
        for b in by_src.get(int(dst[a]), ()):
            aa.append(a); bb.append(b)
    return np.asarray(aa, np.int64), np.asarray(bb, np.int64)


def bond_cosines(r: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """alignn.graphs.compute_bond_cosines: cos of the angle at the shared
    atom j between bonds a=(i->j) and b=(j->k)."""
    r1 = -r[a]
    r2 = r[b]
    num = np.sum(r1 * r2, axis=-1)
    den = np.linalg.norm(r1, axis=-1) * np.linalg.norm(r2, axis=-1)
    return np.clip(num / np.maximum(den, 1e-12), -1.0, 1.0)


@dataclass
class ALIGNNBatch:
    """Flat padded multi-graph batch (DGL ``dgl.batch`` layout + masks)."""

    species: np.ndarray      # [N] atomic numbers (0 on padding)
    node_graph: np.ndarray   # [N] graph id (num_graphs-1 on padding: harmless, masked)
    node_mask: np.ndarray    # [N] bool
    edge_src: np.ndarray     # [E] node index (0 on padding)
    edge_dst: np.ndarray     # [E]
    edge_len: np.ndarray     # [E] bond length (0 on padding)
    edge_mask: np.ndarray    # [E] bool
    trip_a: np.ndarray       # [T] edge index of bond (i->j)
    trip_b: np.ndarray       # [T] edge index of bond (j->k)
    trip_cos: np.ndarray     # [T] bond cosine
    trip_mask: np.ndarray    # [T] bool
    num_graphs: int

    @property
    def padded_sizes(self) -> tuple[int, int, int]:
        return len(self.species), len(self.edge_src), len(self.trip_a)


def _round_up(n: int, mult: int) -> int:
    return max(((n + mult - 1) // mult) * mult, mult)


def build_batch(
    structures: Sequence[Structure],
    cutoff: float = 8.0,
    max_neighbors: int = 12,
    pad_multiple: int = 512,
) -> ALIGNNBatch:
    """Build and concatenate the structures' graphs, the edge and triplet
    lists padded to a multiple of ``pad_multiple`` and the nodes to one of
    64, as the JAX package pads them."""
    species_l: List[np.ndarray] = []
    graph_l: List[np.ndarray] = []
    src_l, dst_l, len_l = [], [], []
    ta_l, tb_l, cos_l = [], [], []
    n_off = 0
    e_off = 0
    for g, s in enumerate(structures):
        src, dst, vec = knn_edges(s, cutoff, max_neighbors)
        a, b = line_graph_pairs(src, dst)
        cos = bond_cosines(vec, a, b)
        species_l.append(np.asarray(s.species, np.int64))
        graph_l.append(np.full(s.num_atoms, g, np.int64))
        src_l.append(src + n_off)
        dst_l.append(dst + n_off)
        len_l.append(np.linalg.norm(vec, axis=-1))
        ta_l.append(a + e_off)
        tb_l.append(b + e_off)
        cos_l.append(cos)
        n_off += s.num_atoms
        e_off += len(src)

    species = np.concatenate(species_l)
    node_graph = np.concatenate(graph_l)
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    elen = np.concatenate(len_l)
    ta = np.concatenate(ta_l)
    tb = np.concatenate(tb_l)
    cos = np.concatenate(cos_l)

    N = _round_up(len(species), 64)
    E = _round_up(len(src), pad_multiple)
    T = _round_up(len(ta), pad_multiple)

    def pad(x, n, fill=0):
        out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
        out[: len(x)] = x
        return out

    num_graphs = len(structures)
    return ALIGNNBatch(
        species=pad(species, N),
        node_graph=pad(node_graph, N, fill=max(num_graphs - 1, 0)),
        node_mask=pad(np.ones(len(species), bool), N, fill=False),
        edge_src=pad(src, E),
        edge_dst=pad(dst, E),
        edge_len=pad(elen, E),
        edge_mask=pad(np.ones(len(src), bool), E, fill=False),
        trip_a=pad(ta, T),
        trip_b=pad(tb, T),
        trip_cos=pad(cos, T),
        trip_mask=pad(np.ones(len(ta), bool), T, fill=False),
        num_graphs=num_graphs,
    )
