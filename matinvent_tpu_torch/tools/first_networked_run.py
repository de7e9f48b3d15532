"""One-shot recipe for the first run of the port on a host with a network
(``tools/first_networked_run.py`` of the JAX package).

Three of the port's bridges to published artifacts are tested against
in-repo stand-ins only, and a run with a network closes them:

  1. ``alex_table``: the ALEX_MP_20 num-atoms histogram from the
     ``mattergen`` wheel, written as a ``num_atoms_distribution_file`` JSON
     (the sampler defaults to mp_20; the table is otherwise supplied by the
     user).
  2. ``alignn_golden``: published ALIGNN checkpoints (Hugging Face
     ``jwchen25/MatInvent``, ``prop_pred/*``) through the port's ALIGNN
     (``rewards/calculators/alignn``) on a fixed set of structures, beside
     the DGL ``alignn`` package's predictions where it is installed.
  3. ``distill``: a published MatterGen checkpoint (``microsoft/mattergen``)
     distilled by ``tools.distill_mattergen``, whose
     ``_builder_mattergen_wheel`` rebuilds the GemNet teacher through the
     external ``mattergen`` package.

Then ``rl_smoke`` runs one RL iteration of ``python -m
matinvent_tpu_torch.main`` with the distilled model and an ALIGNN reward.

Usage on a host with a network:

    pip install mattergen alignn huggingface_hub   # once
    python -m matinvent_tpu_torch.tools.first_networked_run            # all stages
    python -m matinvent_tpu_torch.tools.first_networked_run stages=alignn_golden,alex_table
    python -m matinvent_tpu_torch.tools.first_networked_run plan=1     # the plan, no work

Each stage skips when its artifact exists and writes under
``exp_res/first_networked_run/``. A stage's parameters are set as
``<stage>.<key>=<value>`` (``distill.steps=2000``); the defaults are the
real run's. ``device=cpu`` runs the stages on the CPU; they run on the card
otherwise. ``huggingface_hub``, ``mattergen``, ``alignn`` and ``jarvis``
are imported inside the stages only.

Offline rehearsal: ``tests/test_torch_port_first_networked_run.py`` runs all
four stages on the CPU with sockets blocked, against a fake Hugging Face
snapshot and a fake ``mattergen`` wheel on disk, with the download
functions patched.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

from matinvent_tpu_torch.main import pop_device

OUT = os.path.join("exp_res", "first_networked_run")
# the directory that holds the package, for the distillation subprocess
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# fixed probe set for the ALIGNN goldens: small, chemically diverse, with a
# wrap-boundary coordinate and a triclinic cell (where a misreading of the
# graph construction would show)
GOLDEN_STRUCTURES = [
    # (lattice rows, species, frac coords)
    ([[4.05, 0, 0], [0, 4.05, 0], [0, 0, 4.05]],
     ["Na", "Cl"], [[0, 0, 0], [0.5, 0.5, 0.5]]),
    ([[3.16, 0, 0], [-1.58, 2.74, 0], [0, 0, 5.14]],
     ["Mo", "S", "S"], [[0, 0, 0.5], [1 / 3, 2 / 3, 0.622], [1 / 3, 2 / 3, 0.378]]),
    ([[5.43, 0.2, 0.1], [0.3, 5.1, 0.2], [0.1, 0.2, 6.2]],
     ["Fe", "O", "O", "Ti"],
     [[0.9999, 0.0001, 0.5], [0.25, 0.25, 0.25], [0.75, 0.75, 0.75], [0.5, 0, 0]]),
]


def _plan() -> None:
    print(__doc__)


def _opts(opts: dict | None, **defaults) -> dict:
    o = dict(defaults)
    o.update(opts or {})
    return o


def stage_alex_table(opts: dict | None = None, device=None) -> None:
    """The ALEX_MP_20 num-atoms histogram of the ``mattergen`` wheel, as a
    ``num_atoms_distribution_file`` JSON."""
    out = os.path.join(OUT, "num_atoms_distributions.json")
    if os.path.exists(out):
        print(f"[alex_table] {out} exists; skip")
        return
    from mattergen.common.data.num_atoms_distribution import NUM_ATOMS_DISTRIBUTIONS

    tables = {
        name: {int(k): float(v) for k, v in hist.items()}
        for name, hist in NUM_ATOMS_DISTRIBUTIONS.items()
    }
    os.makedirs(OUT, exist_ok=True)
    with open(out, "w") as fh:
        json.dump(tables, fh, indent=1)
    print(f"[alex_table] wrote {sorted(tables)} -> {out}")
    print(
        "[alex_table] use: MatterGenSampler(num_atoms_distribution='ALEX_MP_20',"
        f" num_atoms_distribution_file='{out}')"
    )


def stage_alignn_golden(opts: dict | None = None, device=None) -> None:
    """Published ALIGNN checkpoints through the port's ALIGNN on the golden
    structures, beside the DGL reference's predictions."""
    o = _opts(opts, tasks="band_gap,formation_energy,bulk_modulus")
    out = os.path.join(OUT, "alignn_goldens.json")
    if os.path.exists(out):
        print(f"[alignn_golden] {out} exists; skip")
        return
    from huggingface_hub import snapshot_download

    ckpt_dir = snapshot_download("jwchen25/MatInvent", allow_patterns="prop_pred/*")

    from matinvent_tpu_torch.chem.data import SYMBOLS, Z_BY_SYMBOL
    from matinvent_tpu_torch.chem.structure import Structure
    from matinvent_tpu_torch.rewards.calculators.alignn.calc import ALIGNN

    strucs = [Structure(l, [Z_BY_SYMBOL[sp] for sp in s], f) for l, s, f in GOLDEN_STRUCTURES]

    native = {}
    for task in o["tasks"].split(","):
        try:
            calc = ALIGNN(root_dir=OUT, task=task, model_dir=ckpt_dir, device=device)
            native[task] = [float(v) for v in calc.calc((strucs, None), "golden")]
        except Exception as e:  # the stage records partial coverage as it is
            native[task] = f"error: {e!r}"

    # the DGL reference (``pip install alignn``)
    reference = {}
    try:
        from alignn.pretrained import get_prediction
        from jarvis.core.atoms import Atoms

        for task, fig_name in (("band_gap", "mp_gappbe_alignn"),
                               ("formation_energy", "mp_e_form_alignn")):
            vals = []
            for s in strucs:
                atoms = Atoms(lattice_mat=s.lattice.tolist(),
                              elements=[SYMBOLS[int(z)] for z in s.species],
                              coords=s.frac_coords.tolist(), cartesian=False)
                vals.append(float(get_prediction(model_name=fig_name, atoms=atoms)[0]))
            reference[task] = vals
    except ImportError:
        reference["error"] = "alignn/jarvis not installed; pip install alignn"

    os.makedirs(OUT, exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"native": native, "dgl_reference": reference,
                   "structures": GOLDEN_STRUCTURES}, fh, indent=1)
    print(f"[alignn_golden] wrote {out}")
    if "error" not in reference:
        for task in reference:
            nat, ref = native.get(task), reference[task]
            if isinstance(nat, list):
                rel = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(nat, ref))
                print(f"[alignn_golden] {task}: max rel dev native-vs-DGL = {rel:.4f}")


def stage_distill(opts: dict | None = None, device=None) -> None:
    """A published MatterGen checkpoint distilled by
    ``tools.distill_mattergen`` (its ``_builder_mattergen_wheel``)."""
    o = _opts(
        opts,
        steps=8000, batch=64, hidden=256, layers=6, timesteps=1000, max_atoms=20,
        corpus=os.path.join("experiments", "data", "reference.extxyz"),
    )
    out_dir = os.path.join(OUT, "distilled_mattergen_base")
    if os.path.exists(os.path.join(out_dir, "params.msgpack")):
        print(f"[distill] {out_dir} exists; skip")
        return
    from huggingface_hub import hf_hub_download

    ckpt = hf_hub_download("microsoft/mattergen", "checkpoints/mattergen_base/last.ckpt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    subprocess.run(
        [sys.executable, "-m", "matinvent_tpu_torch.tools.distill_mattergen",
         f"teacher={ckpt}", f"corpus={o['corpus']}", f"out={out_dir}",
         f"steps={o['steps']}", f"batch={o['batch']}", f"hidden={o['hidden']}",
         f"layers={o['layers']}", f"timesteps={o['timesteps']}",
         f"max_atoms={o['max_atoms']}"] + ([f"device={device}"] if device else []),
        check=True, env=env,
    )
    print(f"[distill] wrote {out_dir} (see distill_summary.json for held-out match)")


def stage_rl_smoke(opts: dict | None = None, device=None) -> None:
    """One RL iteration: the distilled published model, a published-ALIGNN
    reward."""
    o = _opts(opts, overrides="")
    from matinvent_tpu_torch import main as cli

    ckpt_dir = os.path.join(OUT, "distilled_mattergen_base")
    if not os.path.exists(os.path.join(ckpt_dir, "params.msgpack")):
        raise SystemExit("[rl_smoke] run stage `distill` first")
    extra = [s for s in o["overrides"].split(";") if s]
    cli.main([
        f"results_dir={os.path.abspath(OUT)}", "expname=rl_smoke", "rl_epoch=1", "eval_size=16",
        "model=mattergen", f"model.model_path={os.path.abspath(ckpt_dir)}",
        "reward=band_gap_alignn", "logger=csv", *extra,
    ] + ([f"device={device}"] if device else []))
    print(f"[rl_smoke] artifacts under {os.path.join(OUT, 'rl_smoke')}")


STAGES = {
    "alex_table": stage_alex_table,
    "alignn_golden": stage_alignn_golden,
    "distill": stage_distill,
    "rl_smoke": stage_rl_smoke,
}


def main(argv: list[str] | None = None) -> None:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    kv = dict(a.split("=", 1) for a in argv)
    if kv.get("plan"):
        _plan()
        return
    if device is None:
        from matinvent_tpu_torch.device import resolve_device

        resolve_device(None)  # the card, or say that there is none
    names = kv.get("stages", ",".join(STAGES)).split(",")
    for name in names:
        stage_opts = {k.split(".", 1)[1]: v for k, v in kv.items() if k.startswith(name + ".")}
        STAGES[name](stage_opts, device)


if __name__ == "__main__":
    main()
