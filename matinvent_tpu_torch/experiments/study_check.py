"""The JAX package's generation-quality studies at their full sizes on the
card, each held against the JAX record in ``experiments/results/``.

    python -m matinvent_tpu_torch.experiments.study_check [out=runs/study_check] \\
        [results=matinvent_tpu_torch/experiments/results/studies] \\
        [parts=type_temperature,validity_fix,validity_curve,validity_diagnosis,
               reward_tail,heat_capacity,phonon,wt4_warm]

"4 sigma" is ``harness_check.fraction_gate``: the difference of two
fractions in units of the binomial sigma at their mean and the record's n.

* ``type_temperature``: ``type_temperature_ab_r5`` at its defaults (5 tau x
  512 crystals of ``pretrained_geneval_r4`` at T=1000): per tau each leg
  and ``frac_distinct_comps`` within 4 sigma of the record, and ``all_ok``
  at tau 0.5 at least ``TAU_DROP`` below tau 1.0's.
* ``validity_fix``: ``validity_fix_r5`` with ``steps=0`` on each in-repo
  checkpoint of the record (``FIX_RUNS``) at the record's ``n``, corpus and
  seed 1: each leg within 4 sigma. ``r5_h384``'s checkpoint is not in the
  repository: reported as skipped.
* ``validity_curve``: ``validity_curve_r5`` on the one snapshot in the
  repository (``CURVE_CKPT``): each leg within 4 sigma.
* ``validity_diagnosis``: equal to the record in every field JAX writes.
* ``reward_tail``: ``reward_tail_density_r5`` for hhi (exact but
  ``seconds``), magnetic_density and gap_bulk (4,000 each: ``n_scored`` and
  ``n_failed`` equal, ``mean`` and each percentile within ``TAIL_TOL``, each
  fraction within 2/n).
* ``heat_capacity``: the same study for heat capacity (400 structures, the
  MLIP bridge's worker on the card): ``n_failed`` equal, ``mean`` within
  ``HEAT_MEAN_TOL``, p50 and p90 within ``HEAT_PCT_TOL``, ``frac_ge_0p8``
  0; p99 and p99.9 reported.
* ``phonon``: ``phonon_ceiling_split_r5``: every C_v within ``CV_TOL`` of
  the record, the same ``supercell_atoms``. Beside each cell, what the gap
  is made of, reported, not gated: the whole floor modes it amounts to and
  what is left over; at 6 and 8 Å also each part measured against JAX's
  cells recorded on the CPU (``phonon_against_jax``, ``PHONON_JAX``).
* ``wt4_warm``: one 10,000-step ``wt4`` warm start (``validity_fix_r5
  tag=wt4`` into ``<out>/wt4_warm``), ms per step and its legs beside the
  record's; reported, not gated (training noise is not binomial).

Every part's edge-kernel launches equal the plan of its sampling calls
(``LaunchPlan``; 0 in the parts that sample nothing). Each part prints one
JSON line (its gates, seconds, the card's name and
power limit) and copies its study's output to ``results``; the record of
the parts run goes to ``<out>/study_check_<parts>.json``. Exits non-zero
when a gate fails.
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from matinvent_tpu_torch.chem.phonon import (
    MASSES_AMU,
    choose_reps,
    gamma_frequencies,
    harmonic_heat_capacity,
    supercell,
)
from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.experiments import (
    phonon_ceiling_split_r5,
    reward_tail_density_r5,
    type_temperature_ab_r5,
    validity_curve_r5,
    validity_diagnosis_r5,
    validity_fix_r5,
)
from matinvent_tpu_torch.experiments.harness_check import fraction_gate, passed
from matinvent_tpu_torch.experiments.phonon_check import AMU_G, KB
from matinvent_tpu_torch.experiments.timing import card
from matinvent_tpu_torch.models.mattergen.diffusion import MatterGenDiffusion
from matinvent_tpu_torch.ops.fused_edge import fused_edge_chain

ROOT = Path(__file__).resolve().parents[2]
RECORDS = ROOT / "experiments/results"
CORPORA = ROOT / "experiments/data"
PHONON_JAX = Path(__file__).resolve().parent / "results" / "phonon_ceiling_split_jax.json"
LEGS = ("smact_fail", "structural_fail", "cell_fail", "all_ok")
TAU_DROP = 0.2
# (tag, extra arguments) of the record's runs whose checkpoints are in the
# repository; each re-evaluated with steps=0
FIX_RUNS = (
    ("base", []),
    ("wt4", []),
    ("wt1_lr5e5", []),
    ("r5_uniform", ["scratch=1", "kind=uniform"]),
    ("r5_absorbing", ["scratch=1", "kind=absorbing"]),
    ("r5_long", ["scratch=1", "kind=uniform"]),
)
FIX_SKIPPED = ("r5_h384",)
CURVE_CKPT = "pretrained_geneval_r5_r5_long_s120000_ema"
TAIL_TOL = 1e-3
HEAT_MEAN_TOL, HEAT_PCT_TOL = 5e-3, 0.02
# JAX's own +-1e-6 nudge spread at the Li2N design (4.0e-3), rounded up
CV_TOL = 5e-3
FLOOR = 1e10  # rad/s: C_v's floor of the modes it sums over
FLOOR_MODES_MAX = 3  # the three acoustic translations


def leg_gates(ours: dict, record: dict, keys=LEGS) -> dict:
    return {k: fraction_gate(ours[k], record[k], record["n"]) for k in keys}


def run_type_temperature(out: Path) -> tuple[dict, Path]:
    summary = type_temperature_ab_r5.main([f"out={out}"])
    record = json.loads((RECORDS / "type_temperature_ab_r5.json").read_text())
    gates = {}
    for a, b in zip(summary["sweep"], record["sweep"], strict=True):
        gates[f"tau_{a['tau']:g}"] = leg_gates(a, b, LEGS + ("frac_distinct_comps",))
    ok_of = {e["tau"]: e["all_ok"] for e in summary["sweep"]}
    drop = ok_of[1.0] - ok_of[0.5]
    flat = {f"{t}/{k}": g for t, gs in gates.items() for k, g in gs.items()}
    flat["all_ok_drop_tau_0.5"] = dict(ours=drop, least=TAU_DROP,
                                       record=record["sweep"][0]["all_ok"] - record["sweep"][-1]["all_ok"],
                                       ok=drop >= TAU_DROP)
    per_s = {f"tau_{e['tau']:g}": e["n"] / e["sample_seconds"] for e in summary["sweep"]
             if e["sample_seconds"]}
    return dict(gates=flat, sweep=summary["sweep"], structures_per_sec=per_s), \
        out / "type_temperature_ab_r5.json"


def run_validity_fix(out: Path) -> tuple[dict, Path]:
    record = {r["tag"]: r for r in json.loads((RECORDS / "validity_fix_r5.json").read_text())["runs"]}
    gates, entries = {}, {}
    for tag, extra in FIX_RUNS:
        rec = record[tag]
        corpus = CORPORA / rec.get("corpus", "corpus_r4.extxyz")
        entry = validity_fix_r5.main([f"out={out}", f"tag={tag}", "steps=0",
                                      f"sample_n={rec['n']}", f"corpus={corpus}",
                                      f"wt={rec['weight_types']}", f"wpos={rec['weight_pos']}",
                                      f"lr={rec['lr']}", *extra])
        entries[tag] = entry
        gates.update({f"{tag}/{k}": g for k, g in leg_gates(entry, rec).items()})
    skipped = {tag: "checkpoint not in the repository" for tag in FIX_SKIPPED}
    return dict(gates=gates, runs=entries, skipped=skipped), out / "validity_fix_r5.json"


def run_validity_curve(out: Path) -> tuple[dict, Path]:
    data = validity_curve_r5.main([f"out={out}", f"ckpts={CURVE_CKPT}"])
    record = {r["ckpt"]: r for r in json.loads((RECORDS / "validity_curve_r5.json").read_text())["runs"]}
    entry = data["runs"][-1]
    return dict(gates=leg_gates(entry, record[CURVE_CKPT]), entry=entry), \
        out / "validity_curve_r5.json"


def run_validity_diagnosis(out: Path) -> tuple[dict, Path]:
    ours = validity_diagnosis_r5.main([f"out={out}"])
    record = json.loads((RECORDS / "validity_diagnosis_r5.json").read_text())
    gates = {k: dict(ok=ours[k] == record[k]) for k in ours}
    return dict(gates=gates), out / "validity_diagnosis_r5.json"


def tail_gates(ours: dict, rec: dict) -> dict:
    """magnetic_density / gap_bulk: counts equal, the mean and percentiles
    within ``TAIL_TOL``, the fractions within 2/n."""
    gates = {k: dict(ours=ours[k], record=rec[k], ok=ours[k] == rec[k])
             for k in ("n_scored", "n_failed")}
    for k in ["mean"] + [f"percentiles/{p}" for p in rec["percentiles"]]:
        a = ours["percentiles"][k.split("/")[1]] if "/" in k else ours[k]
        b = rec["percentiles"][k.split("/")[1]] if "/" in k else rec[k]
        gates[k] = dict(ours=a, record=b, gap=abs(a - b), ok=abs(a - b) <= TAIL_TOL)
    for k in ("frac_ge_0p8", "frac_ge_threshold"):
        tol = 2.0 / rec["n_scored"]
        gates[k] = dict(ours=ours[k], record=rec[k], gap=abs(ours[k] - rec[k]), tol=tol,
                        ok=abs(ours[k] - rec[k]) <= tol)
    return gates


def run_reward_tail(out: Path) -> tuple[dict, Path]:
    ours = reward_tail_density_r5.main([f"out={out}", "rewards=hhi,magnetic_density,gap_bulk"])
    record = json.loads((RECORDS / "reward_tail_density_r5.json").read_text())
    strip = lambda d: {k: v for k, v in d.items() if k != "seconds"}  # noqa: E731
    gates = {"hhi": dict(ok=strip(ours["hhi"]) == strip(record["hhi"]))}
    for name in ("magnetic_density", "gap_bulk"):
        gates.update({f"{name}/{k}": g for k, g in tail_gates(ours[name], record[name]).items()})
    seconds = {k: ours[k]["seconds"] for k in ("hhi", "magnetic_density", "gap_bulk")}
    return dict(gates=gates, seconds_per_reward=seconds), out / "reward_tail_density_r5.json"


def run_heat_capacity(out: Path) -> tuple[dict, Path]:
    ours = reward_tail_density_r5.main([f"out={out}", "rewards=heat_capacity"])["heat_capacity"]
    rec = json.loads((RECORDS / "reward_tail_density_r5.json").read_text())["heat_capacity"]
    gates = dict(
        n_failed=dict(ours=ours["n_failed"], record=rec["n_failed"],
                      ok=ours["n_failed"] == rec["n_failed"]),
        mean=dict(ours=ours["mean"], record=rec["mean"], gap=abs(ours["mean"] - rec["mean"]),
                  ok=abs(ours["mean"] - rec["mean"]) <= HEAT_MEAN_TOL),
        frac_ge_0p8=dict(ours=ours["frac_ge_0p8"], ok=ours["frac_ge_0p8"] == 0.0),
    )
    for p in ("p50", "p90"):
        a, b = ours["percentiles"][p], rec["percentiles"][p]
        gates[p] = dict(ours=a, record=b, gap=abs(a - b), ok=abs(a - b) <= HEAT_PCT_TOL)
    reported = {p: (ours["percentiles"][p], rec["percentiles"][p]) for p in ("p99", "p99.9")}
    return dict(gates=gates, reported_ours_and_record=reported, scored=ours,
                seconds_per_structure=ours["seconds"] / 400), \
        out / "reward_tail_density_r5.json"


def floor_mode_cv(mass_amu: float) -> float:
    """One mode's classical share of C_v (k_B over the supercell's mass),
    J/(g K): what a mode counted above the floor on one side only adds."""
    return KB / (mass_amu * AMU_G)


def _spectrum(sc: Structure, device) -> tuple[float, int, float]:
    w = np.abs(gamma_frequencies(sc, device=device))
    mass = float(np.sum(MASSES_AMU[np.asarray(sc.species)]))
    return harmonic_heat_capacity(w, mass), int(np.sum(w > FLOOR)), mass


def phonon_against_jax(name: str, min_length: float, cap: int, device) -> dict:
    """One cell of the supercell ladder against JAX's, recorded on the CPU
    (``PHONON_JAX``: JAX's C_v, its equilibrated cell, its modes above the
    1e10 rad/s floor, its C_v with the cell nudged by 1 +- 1e-6), and the
    parts the gap is made of, each measured on both sides:

    * ``floor_modes``: the modes counted above the floor on our side only
      (the three acoustic translations are zero up to f32 rounding and sit
      near the floor), each adding ``floor_mode_cv``; ``gap_floor_modes``
      the gap once they are accounted for;
    * ``lattice_gap`` / ``frac_gap``: the equilibrated cells apart (the
      relaxation leaves a symmetric start, where every force is zero in
      exact arithmetic, along a direction f32 rounding picks);
    * ``probe_gap``: our spectrum at JAX's equilibrated cell, floor modes
      accounted for: the Hessian and C_v alone;
    * ``jax_nudge_gap``: how far JAX's own C_v moves under a 1e-6 nudge.

    ``kind``: ``equal`` (within ``CV_TOL`` of JAX's), ``floor_modes n``,
    ``relaxation`` (cells apart, the probe within ``CV_TOL``) or
    ``differs``."""
    key = f"min_length_{min_length:g}"
    ref = json.loads(PHONON_JAX.read_text())["cells"][name][key]
    design = phonon_ceiling_split_r5.DESIGNS[name]
    sc = phonon_ceiling_split_r5.equilibrated_supercell(design, min_length, cap, device)
    cv, modes, mass = _spectrum(sc, device)
    theirs = Structure(species=ref["species"], frac_coords=np.asarray(ref["frac_coords"]),
                       lattice=np.asarray(ref["lattice"]))
    their_sc = supercell(theirs, choose_reps(theirs, min_length, cap))
    probe, probe_modes, _ = _spectrum(their_sc, device)
    unit = floor_mode_cv(ref["supercell_mass_amu"])
    n, n_probe = modes - ref["modes_above_floor"], probe_modes - ref["modes_above_floor"]
    row = dict(
        design=name, min_length=min_length, cv=cv, supercell_atoms=sc.num_atoms,
        jax=ref["cv"], jax_supercell_atoms=ref["supercell_atoms"], gap=abs(cv - ref["cv"]),
        floor_modes=n, gap_floor_modes=abs(cv - ref["cv"] - n * unit),
        lattice_gap=float(np.abs(sc.lattice - their_sc.lattice).max()),
        frac_gap=float(np.abs((sc.frac_coords - their_sc.frac_coords + 0.5) % 1.0 - 0.5).max())
        if sc.num_atoms == their_sc.num_atoms else None,
        probe=probe, probe_floor_modes=n_probe,
        probe_gap=abs(probe - ref["cv"] - n_probe * unit),
        jax_nudge_gap=max(abs(v - ref["cv"]) for v in ref["cv_nudged"]),
    )
    cells_equal = row["lattice_gap"] <= 1e-6 and (row["frac_gap"] or 0.0) <= 1e-5
    if row["gap"] <= CV_TOL:
        row["kind"] = "equal"
    elif cells_equal and abs(n) <= FLOOR_MODES_MAX and row["gap_floor_modes"] <= CV_TOL:
        row["kind"] = f"floor_modes {n:+d}"
    elif not cells_equal and abs(n_probe) <= FLOOR_MODES_MAX and row["probe_gap"] <= CV_TOL:
        row["kind"] = "relaxation"
    else:
        row["kind"] = "differs"
    return row


def run_phonon(out: Path) -> tuple[dict, Path]:
    ours = phonon_ceiling_split_r5.main([f"out={out}"])
    record = json.loads((RECORDS / "phonon_ceiling_split_r5.json").read_text())
    gates, measured = {}, []
    for name, design in phonon_ceiling_split_r5.DESIGNS.items():
        conv = ours[name]["supercell_convergence"]
        for split in ("supercell_convergence", "potential_split"):
            for key, rec in record[name][split].items():
                got = ours[name][split][key]
                gap = got["cv"] - rec["cv"]
                # the floor modes the gap amounts to (a mode near the floor
                # adds its classical share, k_B over the supercell's mass),
                # and what is left over; the split runs at 10 Å
                atoms = got.get("supercell_atoms", conv["min_length_10"]["supercell_atoms"])
                mass = float(np.sum(MASSES_AMU[np.asarray(design.species)])) * atoms / design.num_atoms
                implied = round(gap / floor_mode_cv(mass))
                gate = dict(ours=got["cv"], record=rec["cv"], gap=abs(gap), ok=abs(gap) <= CV_TOL,
                            implied_floor_modes=implied,
                            left_over=abs(gap - implied * floor_mode_cv(mass)))
                if "supercell_atoms" in rec:
                    gate.update(atoms=(got["supercell_atoms"], rec["supercell_atoms"]))
                    gate["ok"] = gate["ok"] and got["supercell_atoms"] == rec["supercell_atoms"]
                gates[f"{name}/{key}"] = gate
        measured += [phonon_against_jax(name, ml, cap, None)
                     for ml, cap in phonon_ceiling_split_r5.LADDER if ml <= 8.0]
    seconds = {f"{n}/{k}": v["seconds"] for n in phonon_ceiling_split_r5.DESIGNS
               for k, v in ours[n]["supercell_convergence"].items()}
    return dict(gates=gates, against_jax=measured, seconds=seconds), \
        out / "phonon_ceiling_split_r5.json"


def run_wt4_warm(out: Path) -> tuple[dict, Path]:
    entry = validity_fix_r5.main([f"out={out}", "tag=wt4", "steps=10000"])
    rec = {r["tag"]: r for r in json.loads((RECORDS / "validity_fix_r5.json").read_text())["runs"]}["wt4"]
    legs = {k: (entry[k], rec[k]) for k in LEGS + ("n",)}
    return dict(gates={}, legs_ours_and_record=legs, ms_per_step=entry.get("ms_per_step"),
                train_seconds=entry.get("train_seconds"), entry=entry), \
        out / "validity_fix_r5.json"


class LaunchPlan:
    """While active: the edge kernel's launches (``fused_edge_chain``'s
    count, set to 0 on entry) and their plan, summed over every MatterGen
    sampling call (``planned_launches`` per padded batch, times the buckets
    of a bucketed call; no study samples with guidance)."""

    def __enter__(self):
        self.planned = 0
        self._orig = sample, bucketed = MatterGenDiffusion.sample, MatterGenDiffusion.sample_bucketed

        def counted(model, *args, fused_edge=True, **kwargs):
            self.planned += model.planned_launches(fused_edge)
            return sample(model, *args, fused_edge=fused_edge, **kwargs)

        def counted_bucketed(model, noise, na_buckets, caps, *args, fused_edge=True, **kwargs):
            self.planned += model.planned_launches(fused_edge) * len(caps)
            return bucketed(model, noise, na_buckets, caps, *args, fused_edge=fused_edge, **kwargs)

        MatterGenDiffusion.sample, MatterGenDiffusion.sample_bucketed = counted, counted_bucketed
        torch.cuda.synchronize()
        fused_edge_chain.launches = 0
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.launches = fused_edge_chain.launches
        MatterGenDiffusion.sample, MatterGenDiffusion.sample_bucketed = self._orig


PARTS = {"type_temperature": run_type_temperature, "validity_fix": run_validity_fix,
         "validity_curve": run_validity_curve, "validity_diagnosis": run_validity_diagnosis,
         "reward_tail": run_reward_tail, "heat_capacity": run_heat_capacity,
         "phonon": run_phonon, "wt4_warm": run_wt4_warm}
KEPT = {"type_temperature": "type_temperature_ab_r5.json", "validity_fix": "validity_fix_r5.json",
        "validity_curve": "validity_curve_r5.json",
        "validity_diagnosis": "validity_diagnosis_r5.json",
        "reward_tail": "reward_tail_density_r5.json",
        "heat_capacity": "reward_tail_density_r5_heat_capacity.json",
        "phonon": "phonon_ceiling_split_r5.json", "wt4_warm": "validity_fix_r5_wt4_warm.json"}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out = Path(kv.get("out", ROOT / "runs" / "study_check")).resolve()
    results = Path(kv.get("results", Path(__file__).resolve().parent / "results" / "studies")).resolve()
    parts = kv.get("parts", ",".join(PARTS)).split(",")
    if not torch.cuda.is_available():
        raise RuntimeError("study_check measures the card: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    results.mkdir(parents=True, exist_ok=True)
    rec: dict = dict(experiment="study_check", device=card())
    for part in parts:
        t = time.perf_counter()
        with LaunchPlan() as plan:
            check, summary_path = PARTS[part](out / part)
        check["gates"]["edge_kernel_launches"] = dict(
            ours=plan.launches, plan=plan.planned, ok=plan.launches == plan.planned)
        check.update(part=part, device=rec["device"], seconds=time.perf_counter() - t,
                     ok=passed(check["gates"]))
        shutil.copy(summary_path, results / KEPT[part])
        rec[part] = check
        print(json.dumps(check, default=float), flush=True)
    (out / f"study_check_{'_'.join(parts)}.json").write_text(
        json.dumps(rec, indent=1, default=float) + "\n")
    return 0 if all(rec[p]["ok"] for p in parts) else 1


if __name__ == "__main__":
    sys.exit(main())
