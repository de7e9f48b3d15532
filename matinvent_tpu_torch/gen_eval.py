"""Large-batch generation and SUN evaluation (``gen_eval.py`` of the JAX
package), on the card.

    python -m matinvent_tpu_torch.gen_eval model=mattergen \\
        model.model_path=<checkpoint dir> output_dir=gen_out batch_size=32 \\
        num_batches=32 [reference_path=<extxyz>] [reference_energies=<json>] \\
        [relax=true] [num_atoms_from=<extxyz>] \\
        [structure_matcher=disordered,ordered] [device=cpu]

Draws ``batch_size x num_batches`` crystals, writes
``generated_crystals.extxyz``, and writes ``metrics.json`` with the
validity, unique, novel, stable and SUN fractions, the generation time and
throughput, and with more than one matcher tier every tier under
``by_matcher`` (the first is the headline). The ``model...`` arguments
compose ``configs/`` as ``main`` does; ``num_atoms_from`` samples atom
counts from that corpus' histogram (a corpus that is also the reference
is read once).

Generation time excludes one warm launch (which builds the edge kernel)
and overlaps the next launch, in a worker thread, with the host's
conversion of the current batch. With ``relax=true`` the crystals are
relaxed by ``SoftSphereRelaxer`` on the device before evaluation; with a
``reference_energies`` hull their energies are the analytic formation
energy (``chem/proxy_labels``) times the atom count, the hull's own scale.
``OptEval`` runs once per matcher tier on the same structures.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from matinvent_tpu_torch.chem.proxy_labels import formation_energy_ev_per_atom
from matinvent_tpu_torch.chem.relax import SoftSphereRelaxer
from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.main import CONFIG_DIR, pop_device
from matinvent_tpu_torch.models.sample import (
    atom_dist_from_structures,
    batch_to_structures,
    register_atom_dist,
)
from matinvent_tpu_torch.pipeline.filters import OptEval, ReferenceDataset
from matinvent_tpu_torch.pipeline.logger import setup_logging
from matinvent_tpu_torch.pipeline.save import save_structures
from matinvent_tpu_torch.utils.config import instantiate, load_config


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(device)
    setup_logging()
    kv = dict(a.split("=", 1) for a in argv if "=" in a and not a.startswith("model"))
    output_dir = kv.pop("output_dir", "gen_out")
    batch_size = int(kv.pop("batch_size", 32))
    num_batches = int(kv.pop("num_batches", 32))
    reference_path = kv.pop("reference_path", None)
    reference_energies = kv.pop("reference_energies", None)
    relax = kv.pop("relax", "false").lower() in ("1", "true", "yes")
    num_atoms_from = kv.pop("num_atoms_from", None)
    matcher_tiers = [m.strip() for m in kv.pop("structure_matcher", "disordered").split(",")
                     if m.strip()]
    if kv:
        raise ValueError(f"unknown arguments: {sorted(kv)}")

    cfg = load_config(CONFIG_DIR, "base", overrides=[a for a in argv if a.startswith("model")])
    os.makedirs(output_dir, exist_ok=True)
    suite = instantiate(cfg["model"], str(device), "model")
    model = suite.load_model()
    sampler = suite.get_sampler()
    corpus = {}  # a corpus read once when it is both the reference and the histogram's

    def read(path):
        if path not in corpus:
            corpus[path] = read_extxyz(path)
        return corpus[path]

    if num_atoms_from:
        register_atom_dist("corpus", atom_dist_from_structures(read(num_atoms_from)))
        sampler.num_atoms_distribution = "corpus"

    def launch():
        return sampler.launch(model, batch_size=batch_size, num_batches=1)

    logging.info(f"generating {batch_size * num_batches} structures ...")
    launch()  # warm: builds and loads the kernel, outside the timed span
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    all_strucs = []
    with ThreadPoolExecutor(1, thread_name_prefix="sampling") as pool:
        pending = pool.submit(launch)
        for i in range(num_batches):
            current = pending.result()
            if i + 1 < num_batches:
                pending = pool.submit(launch)
            all_strucs.extend(batch_to_structures(current)[1])
    gen_time = time.perf_counter() - t0
    logging.info(f"generated {len(all_strucs)} structures in {gen_time:.1f}s "
                 f"({len(all_strucs) / gen_time:.2f} structures/sec)")
    xyz_path = save_structures(all_strucs, output_dir, "generated_crystals.extxyz")
    logging.info(f"saved {xyz_path}")

    entries = []
    if reference_energies:
        with open(reference_energies) as fh:
            entries = list(json.load(fh).items())
    reference = ReferenceDataset(read(reference_path) if reference_path else [], entries)
    if relax:
        logging.info("relaxing generated structures (SoftSphere) ...")
        all_strucs, _ = SoftSphereRelaxer(device=device)(all_strucs)
    energies = None
    if reference.hull is not None:
        energies = [formation_energy_ev_per_atom(s) * s.num_atoms for s in all_strucs]
        energies = [e if np.isfinite(e) else None for e in energies]

    by_matcher = {}
    for tier in matcher_tiers:
        evaluator = OptEval(relax=False, reference=reference, structure_matcher=tier,
                            device=device)
        by_matcher[tier], _ = evaluator(all_strucs, energies=energies)
        logging.info(f"matcher={tier}: {json.dumps(by_matcher[tier])}")
    metrics = dict(by_matcher[matcher_tiers[0]])
    metrics.update(
        num_generated=len(all_strucs),
        generation_time_s=round(gen_time, 2),
        structures_per_sec=round(len(all_strucs) / gen_time, 3),
        structure_matcher=matcher_tiers[0],
    )
    if len(matcher_tiers) > 1:
        metrics["by_matcher"] = by_matcher
    with open(os.path.join(output_dir, "metrics.json"), "w") as fh:
        json.dump(metrics, fh, indent=2)
        fh.write("\n")
    logging.info(f"metrics: {json.dumps(metrics)}")
    return metrics


if __name__ == "__main__":
    main()
