"""Derive a num-atoms histogram from an extxyz corpus
(``tools/derive_num_atoms_hist.py`` of the JAX package).

    python -m matinvent_tpu_torch.tools.derive_num_atoms_hist <corpus.extxyz> <name> [out.json]

Writes ``{name: {count: probability}}``, the format that
``num_atoms_distribution_file`` reads (``models/mattergen/sample.py``).
"""
from __future__ import annotations

import collections
import json
import sys

from matinvent_tpu_torch.chem.structure import read_extxyz


def derive(corpus_path: str) -> dict[int, float]:
    structures = read_extxyz(corpus_path)
    if not structures:
        raise SystemExit(f"no structures in {corpus_path}")
    counts = collections.Counter(s.num_atoms for s in structures)
    total = sum(counts.values())
    return {int(k): v / total for k, v in sorted(counts.items())}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit(__doc__)
    corpus, name = argv[0], argv[1]
    out_path = argv[2] if len(argv) > 2 else f"{name}_num_atoms.json"
    hist = derive(corpus)
    with open(out_path, "w") as fh:
        json.dump({name: {str(k): v for k, v in hist.items()}}, fh, indent=2)
        fh.write("\n")
    print(f"[derive_num_atoms_hist] {name}: {hist} -> {out_path}")


if __name__ == "__main__":
    main()
